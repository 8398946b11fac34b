"""The model zoo's dense decoders on the port: configs, layers, the model,
and the carrying-over of the reference's weights (``convert``)."""
