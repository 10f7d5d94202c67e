"""The port's counterparts of the reference's examples (``examples/``):
``python -m repro_torch.examples.train_lm`` and
``python -m repro_torch.examples.sparse_probe``."""
