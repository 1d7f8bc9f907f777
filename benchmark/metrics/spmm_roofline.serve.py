"""K1 and K2's share of their byte bound over an eval batch, in %: the
bound of every launch over their profiler device time, for the launches
made inside eval_step."""
from harness.roofline import share


def read(rec):
    return share(rec, "eval", "eval_step", rec.get("eval_batches", 0))
