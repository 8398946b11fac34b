"""The model zoo's data pipeline on the port (``pipeline``)."""
