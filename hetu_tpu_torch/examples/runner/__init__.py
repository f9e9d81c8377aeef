"""The port's runner examples: ``run_mlp.py`` and ``run_wdl.py`` over
the launcher's configs, and ``parallel/``, the parallel-config zoo."""
