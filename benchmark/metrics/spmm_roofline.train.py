"""K1 and K2's share of their byte bound over a training step, in %: the
bound of every launch (harness/counts.py, from the plans' shapes) over
their profiler device time, for the launches made inside train_step.
Silent where the launches counted differ from those the bound counts."""
from harness.roofline import share


def read(rec):
    return share(rec, "train", "train_step", rec.get("steps", 0))
