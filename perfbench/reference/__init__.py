"""Plain PyTorch references of the served models, in fp32 with TF32 off.

They import nothing of the program: they read the weight tree the
benchmark made (the program's key layout) and the sizes and semantics a
configuration file states. ``Precision("fp8")`` computes every linear
product on float8 (e4m3) inputs instead, the control that has to come
out as not correct.
"""
