"""The whole step's least time on the card's published peaks over the
measured step time (the unprofiled window's), %: the larger of the
model's forward, backward and optimizer operations at 67 TFLOP/s
(float32 off the tensor cores: the configurations' precision, TF32 off)
and the step's necessary HBM bytes at 3.35 TB/s (roofline.py)."""

from ctrbench import roofline


def read(summary):
    w = summary["work"]
    least = roofline.least_time(w["flops"], w["bytes"])["seconds"]
    return 100.0 * least / summary["window"]["step_s"]
