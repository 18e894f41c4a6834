"""Counterparts of the reference's ``examples/`` drivers, run as
``python -m repro_torch.examples.<name>`` (``quickstart``, ``train_lm``,
``serve_lm``); each takes ``--device cpu`` to run on the CPU."""
