"""One module a kind of system under test: its ``Cell`` (see
``harness/runner.py``)."""
