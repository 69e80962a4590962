"""mfu_pct.vgg: the train step's model operations a second over the
card's dense bf16 peak, in percent, over the unprofiled window (a
float32 run's share is understated).  Operations:
``portbench/counts/flops.py``'s VGG count."""

from portbench.counts.flops import train_step_flops, vgg_fwd_flops


def read(run):
    r, c, t = run.record, run.config, run.traffic
    if run.peaks is None or not r.get("window_s"):
        return None
    per_step = train_step_flops(vgg_fwd_flops(
        t["batch"], tuple(c["layers"]), c["image_size"], c["num_classes"]))
    return 100.0 * per_step * r["steps"] / r["window_s"] / run.peaks[0]
