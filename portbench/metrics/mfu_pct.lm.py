"""mfu_pct.lm: the train step's model operations a second a chip over
the card's dense bf16 peak, in percent, over the unprofiled window.
Operations: ``portbench/counts/flops.py``'s causal GPT-2 count."""

from portbench.counts.flops import gpt2_fwd_flops_causal, train_step_flops


def read(run):
    r, c, t = run.record, run.config, run.traffic
    if run.peaks is None or not r.get("window_s"):
        return None
    per_step = train_step_flops(gpt2_fwd_flops_causal(
        t["batch"], t["seq_len"], num_layers=c["n_layer"],
        d_model=c["n_embd"], vocab_size=c["vocab_size"]))
    return 100.0 * per_step * r["steps"] / r["window_s"] / run.peaks[0]
