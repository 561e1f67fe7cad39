"""The port's native host code: the one-pass C++ CSV parser (`ingest.py`,
`csv_ingest.cpp`), built with g++ at first use, and the columnar sidecar
(`sidecar.py`) that keeps what it parsed for the next scan."""

from avenir_tpu_torch.native.ingest import native_available

__all__ = ["native_available"]
