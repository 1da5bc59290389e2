from .analysis import BytesCounterMode, RooflineReport, analyze_traced, collective_traffic

__all__ = ["RooflineReport", "BytesCounterMode", "analyze_traced", "collective_traffic"]
