"""The port's chunked vocabulary loss (``tpudp_torch.ops.losses``,
``loss_chunk=``) and ``remat=`` against the JAX package, on the CPU.

The chunked cross entropy and its gradients, and the chunked eval
metrics, equal JAX's ``tpudp/ops/losses.py`` at 1e-5 at
``tests/test_losses.py``'s awkward sizes (24 tokens in chunks of 5, 8,
24 and 1000: ragged last chunks included).  A ``loss_chunk`` step
follows the plain step within 1e-5; the eval and forward steps and the
Trainer take the option, with JAX's refusals.  A ``remat`` step equals the plain step bit
for bit — GPT-2's, and the VGG's with its BatchNorm running statistics,
which move once a step under the recomputation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudp.ops.losses import chunked_lm_metrics as jax_chunked_metrics
from tpudp.ops.losses import chunked_softmax_xent as jax_chunked_xent
from tpudp_torch import train
from tpudp_torch.models import gpt2, llama, vgg
from tpudp_torch.ops import losses
from tpudp_torch.trainer import Trainer

B, T, D, V = 2, 12, 16, 37  # JAX's: T * B not chunk-divisible
CFG = dict(vocab_size=V, max_seq_len=T, num_layers=2, num_heads=2,
           d_model=D)
NARROW = (8, "M", 16, "M", "M", "M", "M")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, D)).astype(np.float32),
            rng.normal(size=(V, D)).astype(np.float32),
            rng.integers(0, V, size=(B, T)).astype(np.int32))


@pytest.mark.parametrize("chunk", [5, 8, 24, 1000])
def test_chunked_xent_and_grads_match_jax(chunk):
    hidden, emb, targets = _setup()
    want, (wh, we) = jax.value_and_grad(jax_chunked_xent, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(emb), jnp.asarray(targets), chunk)
    h = torch.tensor(hidden, requires_grad=True)
    e = torch.tensor(emb, requires_grad=True)
    got = losses.chunked_softmax_xent(h, e, torch.as_tensor(targets), chunk)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(wh), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(we), rtol=1e-5,
                               atol=1e-5)


def test_chunked_xent_equals_dense():
    hidden, emb, targets = _setup(1)
    h = torch.as_tensor(hidden)
    dense = torch.nn.functional.cross_entropy(
        (h.reshape(-1, D) @ torch.as_tensor(emb).T),
        torch.as_tensor(targets).reshape(-1).long(), reduction="sum")
    got = losses.chunked_softmax_xent(h, torch.as_tensor(emb),
                                      torch.as_tensor(targets), 7)
    np.testing.assert_allclose(float(got), float(dense), rtol=1e-5)


@pytest.mark.parametrize("chunk", [7, 24])
def test_chunked_metrics_match_jax(chunk):
    hidden, emb, targets = _setup(2)
    weights = np.array([1.0, 0.0], np.float32)  # the second sample padded
    want = jax_chunked_metrics(jnp.asarray(hidden), jnp.asarray(emb),
                               jnp.asarray(targets), jnp.asarray(weights),
                               chunk)
    got = losses.chunked_lm_metrics(
        torch.as_tensor(hidden), torch.as_tensor(emb),
        torch.as_tensor(targets), torch.as_tensor(weights), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_chunk_size_must_be_positive():
    hidden, emb, targets = (torch.as_tensor(a) for a in _setup())
    for fn, args in ((losses.chunked_softmax_xent, (hidden, emb, targets)),
                     (losses.chunked_lm_metrics,
                      (hidden, emb, targets, torch.ones(B)))):
        with pytest.raises(ValueError, match=">= 1"):
            fn(*args, 0)


# -- the steps ---------------------------------------------------------------

def _gpt2(seed=3):
    model = gpt2.GPT2(gpt2.GPT2Config(**CFG))
    model.load_state_dict(gpt2.params_from_jax(
        gpt2.random_params(gpt2.GPT2Config(**CFG), seed)))
    return model


def _batches(n=3, seed=4):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, V, size=(n, B, T)).astype(np.int64)
    return [(torch.as_tensor(x), torch.as_tensor(np.roll(x, -1, 1)))
            for x in tok]


def _run(model, **kw):
    spec = train.make_optimizer(learning_rate=0.1)
    state = train.init_state(model, spec)
    step = train.make_train_step(model, spec, **kw)
    out = []
    for x, y in _batches():
        state, loss = step(state, x, y)
        out.append(float(loss))
    return out, {k: v.clone() for k, v in model.state_dict().items()}


def test_loss_chunk_step_follows_the_plain_step():
    plain, p0 = _run(_gpt2())
    chunked, p1 = _run(_gpt2(), loss_chunk=5)
    np.testing.assert_allclose(chunked, plain, rtol=1e-5, atol=1e-5)
    for k in p0:
        np.testing.assert_allclose(p1[k].numpy(), p0[k].numpy(), atol=1e-5)


def test_eval_and_forward_steps_take_loss_chunk():
    model = _gpt2()
    x, y = _batches(1, seed=9)[0]
    w = torch.tensor([1.0, 0.0])
    plain = train.make_eval_step(model)(None, x, y, w)
    chunked = train.make_eval_step(model, loss_chunk=7)(None, x, y, w)
    np.testing.assert_allclose([float(v) for v in chunked],
                               [float(v) for v in plain], rtol=1e-5)
    hidden = train.make_forward_step(model, loss_chunk=7)(None, x)
    assert hidden.shape == (B, T, D)
    logits = train.make_forward_step(model)(None, x)
    np.testing.assert_allclose(
        (hidden @ model.wte.weight.T).detach().numpy(), logits.numpy(),
        atol=1e-5)


def test_loss_chunk_refusals():
    lm = llama.Llama(llama.LlamaConfig(vocab_size=V, max_seq_len=T,
                                       num_layers=1, num_heads=2,
                                       d_model=D))
    spec = train.make_optimizer()
    for make in (lambda: train.make_train_step(lm, spec, loss_chunk=4),
                 lambda: train.make_eval_step(lm, loss_chunk=4),
                 lambda: train.make_forward_step(lm, loss_chunk=4)):
        with pytest.raises(ValueError, match="tied-embedding head"):
            make()
    with pytest.raises(ValueError, match="timing_mode='split'"):
        Trainer(_gpt2(), loss_chunk=4, timing_mode="split")


@pytest.mark.parametrize("loss_chunk", [0, -1])
def test_loss_chunk_below_one_is_refused(loss_chunk):
    model, spec = _gpt2(), train.make_optimizer()
    for make in (lambda: train.make_train_step(model, spec,
                                               loss_chunk=loss_chunk),
                 lambda: train.make_eval_step(model, loss_chunk=loss_chunk),
                 lambda: train.make_forward_step(model,
                                                 loss_chunk=loss_chunk)):
        with pytest.raises(ValueError, match="loss_chunk must be >= 1"):
            make()


# -- remat -------------------------------------------------------------------

def test_remat_step_is_bit_equal_gpt2():
    plain, p0 = _run(_gpt2())
    remat, p1 = _run(_gpt2(), remat=True)
    assert remat == plain
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def _vgg():
    model = vgg.VGG(NARROW)
    model.load_state_dict(vgg.params_from_jax(*vgg.random_params(NARROW,
                                                                 5)))
    return model


def _vgg_run(**kw):
    model = _vgg()
    spec = train.make_optimizer(learning_rate=0.05)
    state = train.init_state(model, spec)
    step = train.make_train_step(model, spec, **kw)
    rng = np.random.default_rng(6)
    out = []
    for _ in range(3):
        x = torch.as_tensor(rng.normal(size=(8, 32, 32, 3)).astype(
            np.float32))
        y = torch.as_tensor(rng.integers(0, 10, 8))
        state, loss = step(state, x, y)
        out.append(float(loss))
    return out, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_remat_step_is_bit_equal_with_batchnorm(grad_accum):
    """The running statistics move once a microbatch, not again in the
    recomputed forward."""
    plain, p0 = _vgg_run(grad_accum=grad_accum)
    remat, p1 = _vgg_run(grad_accum=grad_accum, remat=True)
    assert remat == plain
    stats = [k for k in p0 if "running" in k]
    assert stats
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


def test_trainer_takes_remat_and_loss_chunk():
    class Loader:
        def __init__(self):
            self.batches = [(x, y, torch.ones(B)) for x, y in _batches()]

        def set_epoch(self, epoch):
            pass

        def __iter__(self):
            return iter(self.batches)

        def __len__(self):
            return len(self.batches)

    records = {}
    for name, kw in (("plain", {}), ("remat", {"remat": True}),
                     ("chunk", {"loss_chunk": 5})):
        trainer = Trainer(_gpt2(), learning_rate=0.1, log_every=1,
                          log_fn=lambda line: None, **kw)
        trainer.fit(Loader(), epochs=1)
        records[name] = (trainer.metrics()["loss_sum"],
                         trainer.evaluate(Loader()))
    assert records["remat"] == records["plain"]
    np.testing.assert_allclose(records["chunk"][0], records["plain"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(records["chunk"][1], records["plain"][1],
                               rtol=1e-5)
