"""Launchers of the port: ``train.py`` (the training driver),
``serve.py`` (the simulated overlay), ``mesh.py``, ``dryrun.py`` and
``roofline.py`` (the dry-run over a fake process group and its table)."""
