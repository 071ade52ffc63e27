"""Serving: an exported generator (weights + config) and an HTTP server."""

from audiogan_tpu_torch.serve.export import (ServedSampler, export_sampler,
                                             load_sampler)
from audiogan_tpu_torch.serve.server import make_server

__all__ = ["export_sampler", "load_sampler", "ServedSampler", "make_server"]
