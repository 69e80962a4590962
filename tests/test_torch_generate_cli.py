"""The port's generate CLI (``python -m tpudp_torch.generate_cli``)
against ``examples/generate_gpt2.py`` and the port's decode functions,
on the CPU.

Its refusals give the example's messages (the example's own checks run
in-process before it imports JAX).  On a checkpoint the port wrote
(``train_cli --save-checkpoint``), greedy, sampled, ``--beam`` and
``--concurrent`` output equals ``generate()``, ``beam_search()`` and
greedy again on the trained model, and the checkpoint's structure checks
name it as the example does.  Without ``--device cpu`` it needs the
card.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from tpudp_torch import generate_cli, train_cli
from tpudp_torch.models.generate import beam_search, generate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--layers", "2", "--d-model", "32", "--heads", "2", "--vocab", "61",
        "--seq-len", "64"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite's workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_example_exit(argv) -> str:
    """The message ``examples/generate_gpt2.py`` exits with for ``argv``
    (its flag refusals come before any JAX import)."""
    spec = importlib.util.spec_from_file_location(
        "generate_gpt2", os.path.join(ROOT, "examples", "generate_gpt2.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    saved = sys.argv
    sys.argv = ["generate_gpt2.py"] + argv
    try:
        with pytest.raises(SystemExit) as e:
            module.main()
    finally:
        sys.argv = saved
    return str(e.value)


@pytest.mark.parametrize("argv", [
    ["--beam", "2", "--temperature", "0.5"],
    ["--beam", "2", "--top-k", "3"],
    ["--beam", "2", "--concurrent", "2"],
    ["--concurrent", "0"],
    ["--temperature", "-1"],
    ["--top-p", "0.9"],
], ids=["beam-temperature", "beam-top-k", "beam-concurrent",
        "concurrent-0", "negative-temperature", "top-p-greedy"])
def test_refusals_match_the_example(argv):
    with pytest.raises(SystemExit) as e:
        generate_cli.main(["--device", "cpu"] + argv)
    assert str(e.value) == _jax_example_exit(argv)


def test_prompt_and_family_refusals():
    for argv, match in ((["--prompt-ids", "1,x"], "comma-separated"),
                        (["--prompt-ids", "1,99"], r"in \[0, 61\)"),
                        (["--kv-heads", "2"], "llama-family option"),
                        (["--family", "llama", "--kv-heads", "3"],
                         "error: ")):
        with pytest.raises(SystemExit, match=match):
            generate_cli.main(["--device", "cpu"] + TINY + argv)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny GPT-2 trained 2 steps and saved by ``train_cli``; the
    trained model in memory beside its checkpoint directory."""
    root = str(tmp_path_factory.mktemp("gen") / "gpt2")
    run = train_cli.train(train_cli.parse_args(
        ["--device", "cpu", "--batch-size", "2", "--steps", "2",
         "--log-every", "1", "--dtype", "float32", "--save-checkpoint",
         root] + TINY))
    return root, run["model"]


def _cli(root, *extra):
    return generate_cli.main(["--device", "cpu", "--checkpoint-dir", root,
                              "--prompt-ids", "3,1,4,1,5,9",
                              "--max-new-tokens", "6", *TINY, *extra])


def test_outputs_equal_the_port_functions(trained, capsys):
    root, model = trained
    prompt = torch.tensor([[3, 1, 4, 1, 5, 9]])
    greedy = generate(model, prompt, 6)[0, 6:].tolist()
    out = _cli(root)
    assert out["tokens"] == greedy and out["mode"] == "greedy"
    text = capsys.readouterr().out
    assert f"restored params from {root}/step_2" in text
    assert f"tokens: {greedy}" in text and "ms a new token" in text
    seqs, scores = beam_search(model, prompt, 6, beam_width=3)
    out = _cli(root, "--beam", "3")
    assert out["tokens"] == seqs[0, 6:].tolist()
    assert out["score"] == pytest.approx(float(scores[0]), abs=1e-6)
    assert f"[generate] beam=3 logprob={float(scores[0]):.4f}" in \
        capsys.readouterr().out
    assert _cli(root, "--beam", "1")["tokens"] == greedy
    out = _cli(root, "--concurrent", "3")
    assert out["tokens"] == [greedy] * 3
    gen = torch.Generator().manual_seed(7)
    want = generate(model, prompt, 6, temperature=0.8, top_k=5,
                    generator=gen)[0, 6:].tolist()
    assert _cli(root, "--temperature", "0.8", "--top-k", "5", "--seed",
                "7")["tokens"] == want


@pytest.mark.parametrize("flags,message", [
    (["--layers", "3"], "holds 2 layers and wte"),
    (["--vocab", "62"], r"wte \(61, 32\)"),
    (["--seq-len", "96"], r"holds wpe \(64, 32\)"),
    (["--family", "llama", "--kv-heads", "2", "--heads", "2"],
     "is a gpt2-family checkpoint")])
def test_checkpoint_structure_checks(trained, flags, message):
    root, _ = trained
    with pytest.raises(SystemExit, match=message) as e:
        _cli(root, *flags)
    assert str(e.value).startswith("error:")


def test_random_weights_and_the_card(tmp_path, capsys):
    out = generate_cli.main(["--device", "cpu", "--max-new-tokens", "3"])
    ids = np.random.default_rng(0).integers(0, 256, size=4096)[:8].tolist()
    assert out["prompt"] == ids and len(out["tokens"]) == 3
    assert "RANDOM-INIT weights from seed 0" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no step_N checkpoint"):
        generate_cli.main(["--device", "cpu", "--checkpoint-dir",
                           str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            generate_cli.main(["--max-new-tokens", "1"])
