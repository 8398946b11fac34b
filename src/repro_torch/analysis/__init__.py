from repro_torch.analysis.roofline import HW, RooflineReport, analyze

__all__ = ["HW", "RooflineReport", "analyze"]
