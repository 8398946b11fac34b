"""Step builders of the model zoo on the port: prefill and decode on one
device (``step``)."""
