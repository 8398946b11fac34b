"""Launchers of the port: ``dsp_serve`` serves a built-in pipeline
through :class:`repro_torch.graph.service.PipelineService`."""
