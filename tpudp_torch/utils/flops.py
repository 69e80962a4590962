"""Analytic FLOPs accounting and MFU — the port of
``tpudp/utils/flops.py``.

The counts follow JAX's convention: matmul and convolution FLOPs only
(2 x MACs), elementwise, norm and pool work left out, and a train step
3 x its forward (the backward is 2 x).  MFU divides the achieved model
FLOPs a second by the card's peak; as in JAX, the peak is the dense
bf16 figure whatever the compute dtype, which understates a float32
run's utilization.

:func:`counted_flops` is the counterpart of JAX's ``xla_cost_flops``:
an independent count by ``torch.utils.flop_counter.FlopCounterMode``.
"""

from __future__ import annotations

# NVIDIA's published dense bf16 tensor-core peaks (FLOPs/s), keyed by
# substrings of torch.cuda.get_device_name(); first match wins, so the
# PCIe part precedes the generic H100 entry.
_PEAK_BF16: tuple[tuple[str, float], ...] = (
    ("h100 pcie", 756e12),
    ("h100 80gb hbm3", 989.4e12),  # the SXM5 part at 700 W
    ("h100 sxm", 989.4e12),
)


def chip_peak_flops(device_name: str) -> float | None:
    """The card's dense bf16 peak for a ``torch.cuda.get_device_name()``
    string, or None for a card the table does not hold (or the CPU)."""
    name = device_name.lower()
    for key, peak in _PEAK_BF16:
        if key in name:
            return peak
    return None


def mfu(flops_per_step: float, sec_per_step: float,
        device_name: str, n_devices: int = 1) -> float | None:
    """Achieved fraction of peak: ``flops / (time * n * peak)``."""
    peak = chip_peak_flops(device_name)
    if peak is None or sec_per_step <= 0:
        return None
    return flops_per_step / (sec_per_step * n_devices * peak)


# -- per-model analytic counts (forward, per batch) ---------------------------

def conv2d_flops(batch: int, h_out: int, w_out: int, c_in: int, c_out: int,
                 kh: int, kw: int) -> int:
    return 2 * batch * h_out * w_out * c_in * c_out * kh * kw


def dense_flops(batch: int, d_in: int, d_out: int) -> int:
    return 2 * batch * d_in * d_out


def vgg_fwd_flops(batch: int, variant: str = "VGG11", image_size: int = 32,
                  num_classes: int = 10) -> int:
    """Walk the variant's config table
    (:data:`tpudp_torch.models.vgg.CONFIGS`)."""
    from tpudp_torch.models.vgg import CONFIGS

    h, c_in, total = image_size, 3, 0
    for v in CONFIGS[variant]:
        if v == "M":
            h //= 2
        else:
            total += conv2d_flops(batch, h, h, c_in, int(v), 3, 3)
            c_in = int(v)
    return total + dense_flops(batch, c_in * h * h, num_classes)


def resnet_fwd_flops(batch: int, stage_sizes=(3, 4, 6, 3),
                     image_size: int = 224, num_classes: int = 1000,
                     width: int = 64) -> int:
    """The bottleneck ResNet of :mod:`tpudp_torch.models.resnet`: the
    7x7/2 stem, the 3x3/2 max-pool, stages of 1x1 -> 3x3 -> 1x1 (x4)
    blocks with a projection on each stage's first block, the head."""
    h = image_size // 2  # stem conv stride 2
    total = conv2d_flops(batch, h, h, 3, width, 7, 7)
    h = (h + 1) // 2  # maxpool stride 2
    c_in = width
    for stage, num_blocks in enumerate(stage_sizes):
        w = width * (2 ** stage)
        for block in range(num_blocks):
            stride = 2 if (stage > 0 and block == 0) else 1
            h_out = h // stride
            total += conv2d_flops(batch, h, h, c_in, w, 1, 1)
            total += conv2d_flops(batch, h_out, h_out, w, w, 3, 3)
            total += conv2d_flops(batch, h_out, h_out, w, 4 * w, 1, 1)
            if block == 0:  # projection shortcut
                total += conv2d_flops(batch, h_out, h_out, c_in, 4 * w, 1, 1)
            c_in, h = 4 * w, h_out
    return total + dense_flops(batch, c_in, num_classes)


def gpt2_fwd_flops(batch: int, seq_len: int, *, num_layers: int = 12,
                   d_model: int = 768, vocab_size: int = 50_257,
                   mlp_ratio: int = 4) -> int:
    """Per layer the qkv (3d^2), projection (d^2) and MLP (2 ratio d^2)
    matmuls a token, the quadratic score and value matmuls, and the LM
    head."""
    tokens = batch * seq_len
    per_layer = dense_flops(tokens, d_model, 3 * d_model)
    per_layer += dense_flops(tokens, d_model, d_model)
    per_layer += 2 * dense_flops(tokens, d_model, mlp_ratio * d_model)
    per_layer += 2 * 2 * batch * seq_len * seq_len * d_model  # QK^T + AV
    return num_layers * per_layer + dense_flops(tokens, d_model, vocab_size)


def llama_fwd_flops(batch: int, seq_len: int, *, num_layers: int,
                    d_model: int, vocab_size: int, hidden: int,
                    num_heads: int, kv_heads: int) -> int:
    """LLaMA: ``wq`` and ``wo`` at d^2, ``wk`` and ``wv`` narrowed by the
    grouped-query ratio, SwiGLU's three d x hidden matmuls, the quadratic
    attention and the untied LM head."""
    tokens = batch * seq_len
    kv_dim = d_model * kv_heads // num_heads
    per_layer = dense_flops(tokens, d_model, d_model)       # wq
    per_layer += 2 * dense_flops(tokens, d_model, kv_dim)   # wk, wv
    per_layer += dense_flops(tokens, d_model, d_model)      # wo
    per_layer += 3 * dense_flops(tokens, d_model, hidden)   # gate, up, down
    per_layer += 2 * 2 * batch * seq_len * seq_len * d_model  # QK^T + AV
    return num_layers * per_layer + dense_flops(tokens, d_model, vocab_size)


def train_step_flops(fwd_flops: int) -> int:
    """A train step: the forward, and a backward of twice its work."""
    return 3 * fwd_flops


def pipeline_bubble_fraction(stages: int, n_microbatches: int,
                             interleave: int = 1) -> float:
    """The idle share of a 1F1B schedule: ``(S-1) / (V*M + S-1)`` for
    ``S`` stages, ``M`` microbatches and ``V`` virtual stages a device
    (Megatron's interleaved schedule); 0 at one stage.  A pipeline row's
    MFU ceiling is ``(1 - bubble)`` times its data-parallel row's."""
    if stages < 1 or n_microbatches < 1 or interleave < 1:
        raise ValueError(
            f"stages ({stages}), n_microbatches ({n_microbatches}) and "
            f"interleave ({interleave}) must all be >= 1")
    if stages == 1:
        return 0.0
    return (stages - 1) / (interleave * n_microbatches + stages - 1)


def counted_flops(fn, *args, **kwargs) -> int:
    """The FLOPs ``torch.utils.flop_counter.FlopCounterMode`` counts in
    one call of ``fn(*args, **kwargs)``: PyTorch's own matmul and
    convolution count, a cross-check of the analytic ones.  It sees only
    the aten operators it has formulas for, and not the hand-written
    kernels (K1-K6 launch through ``ctypes``, outside the dispatcher),
    so MFU on the card takes the analytic counts above."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())
