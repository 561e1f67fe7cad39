"""Run signals from captured spans: the port's `avenir_tpu/tune/`, cut to
`RunSignals` and `extract_signals`, which the sharded driver's straggler
detector reads (`dist/detect.py`)."""

from avenir_tpu_torch.tune.signals import RunSignals, extract_signals

__all__ = ["RunSignals", "extract_signals"]
