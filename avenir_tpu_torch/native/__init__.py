"""The port's native host code: the one-pass C++ CSV parser (`ingest.py`,
`csv_ingest.cpp`), built with g++ at first use."""

from avenir_tpu_torch.native.ingest import native_available

__all__ = ["native_available"]
