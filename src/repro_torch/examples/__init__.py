"""Twins of the reference's ``examples/`` scripts, each run as
``python -m repro_torch.examples.<name>``: ``quickstart``, ``serve_batch``,
``serve_strum``, ``train_e2e`` and ``dryrun_cell``.  Each has ``run(...)``,
which takes a config and inputs and returns what the script prints as a
dict, and ``main(argv=None)``, which parses the reference's flags (plus
``--device``, default ``"cuda"``) and calls ``run``."""
