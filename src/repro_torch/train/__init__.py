"""Training — port of ``repro.train``: optimizers (``optimizer``), the
train step and fault-tolerant loop (``trainer``), checkpoints in the
reference's format (``checkpoint``), synthetic data (``data``) and the
trees they walk (``tree``)."""
