"""Multi-rank paths on ``torch.distributed``: process groups and their
launcher (``mesh``), and row-sharded single-image inference (``spatial``).
Data-parallel inference and training live in ``infer/engine.py`` and
``train/trainer.py``, which take a process group."""
