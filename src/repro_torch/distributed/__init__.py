"""The model zoo's steps and their distribution rules on the port: the
train, prefill and decode steps on one device (``step``), the
logical-axis context (``context``), the parameter / optimizer / batch /
cache sharding specs (``sharding``) and the GPipe train step over a
``stage`` mesh (``pipeline``)."""
