"""The examples of the port, run as modules on the CUDA card unless
``--device cpu``: the PSO examples (the reference's
``examples/quickstart.py``, ``constrained.py`` and
``custom_objective.py``) and the LM examples (``examples/train_lm.py``,
``examples/tune_lm_hparams.py``), e.g.
``python -m repro_torch.examples.quickstart``."""
