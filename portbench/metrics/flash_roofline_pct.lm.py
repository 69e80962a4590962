"""flash_roofline_pct.lm: the least time the card could take for the
flash attention calls of the profiled steps (each call the larger of its
operations over the bf16 peak and its bytes over the HBM bandwidth,
``portbench/counts/flash.py``) over the device time of every kernel
launched inside ``_Flash``'s forward and backward ranges, in percent."""

from portbench.counts import flash

ELEM = {"bfloat16": 2, "float32": 4}


def read(run):
    tr = run.record.get("trace")
    if run.peaks is None or not tr:
        return None
    rng = tr["ranges"].get("flash")
    if not rng or rng["device_s"] <= 0:
        return None
    c, t = run.config, run.traffic
    shape = (t["batch"], t["seq_len"], c["n_head"],
             c["n_embd"] // c["n_head"], ELEM[c["program"]["dtype"]])
    bound = (rng["fwd_calls"] * flash.bound_seconds(
        *flash.forward(*shape), *run.peaks)
        + rng["bwd_calls"] * flash.bound_seconds(
            *flash.backward(*shape), *run.peaks))
    return 100.0 * bound / rng["device_s"]
