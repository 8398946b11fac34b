"""Launchers of the port: ``dsp_serve`` serves a built-in pipeline
through :class:`repro_torch.graph.service.PipelineService`; ``serve``
and ``train`` run the model zoo; ``dryrun`` counts every (architecture x
shape) cell's step on meta tensors against the H100 roofline, over the
grid of ``shapes``."""
