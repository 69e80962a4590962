"""Analytic operation counts of a training step, frozen for the benchmark.

A copy of the port's ``utils/flops.py`` as it stood when the benchmark
was defined, with one change: GPT-2's attention is counted causal (the
score and value products cover half the square), where the program's
copy counts the whole square.  Matmul and convolution operations only
(2 x multiply-adds); a train step is 3 x its forward.  The tests in
``portbench/tests`` hold these counts to the program's at small sizes.
"""

from __future__ import annotations

# VGG variants as the reference's ``src/Part 1/model.py`` lists them.
VGG_LAYERS: dict[str, tuple] = {
    "VGG11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
              "M"),
}


def conv2d_flops(batch: int, h_out: int, w_out: int, c_in: int, c_out: int,
                 kh: int, kw: int) -> int:
    return 2 * batch * h_out * w_out * c_in * c_out * kh * kw


def dense_flops(batch: int, d_in: int, d_out: int) -> int:
    return 2 * batch * d_in * d_out


def vgg_fwd_flops(batch: int, layers: tuple, image_size: int = 32,
                  num_classes: int = 10) -> int:
    """3x3 convolutions at 'same' padding, 2x2 pools, one Linear head."""
    h, c_in, total = image_size, 3, 0
    for v in layers:
        if v == "M":
            h //= 2
        else:
            total += conv2d_flops(batch, h, h, c_in, int(v), 3, 3)
            c_in = int(v)
    return total + dense_flops(batch, c_in * h * h, num_classes)


def gpt2_fwd_flops_causal(batch: int, seq_len: int, *, num_layers: int,
                          d_model: int, vocab_size: int,
                          mlp_ratio: int = 4) -> int:
    """Per layer the qkv, projection and MLP matmuls, the causal score
    and value products (half of the ``t x t`` square each), then the
    tied LM head."""
    tokens = batch * seq_len
    per_layer = dense_flops(tokens, d_model, 3 * d_model)
    per_layer += dense_flops(tokens, d_model, d_model)
    per_layer += 2 * dense_flops(tokens, d_model, mlp_ratio * d_model)
    per_layer += 2 * batch * seq_len * seq_len * d_model  # QK^T + AV, halved
    return num_layers * per_layer + dense_flops(tokens, d_model, vocab_size)


def train_step_flops(fwd_flops: int) -> int:
    """The forward and a backward of twice its work."""
    return 3 * fwd_flops
