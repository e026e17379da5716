"""The LM examples of the port (the reference's ``examples/train_lm.py``
and ``examples/tune_lm_hparams.py``), run as modules:
``python -m repro_torch.examples.train_lm``."""
