"""A served batch as one CUDA graph: the port's counterpart of the
reference's compiled sampler artifact, "One jit'd graph: z = normal(seed)
-> G -> inverse mu-law expand" (audiogan_tpu/train/sample.py:1-5),
exported at a fixed batch (audiogan_tpu/serve/export.py:51-62) and called
once per request (:82-88, 102-117).

``SampleGraph`` holds the artifact's batch ``num`` in fixed buffers: z
[num, latent_dim] f32, the labels [num] int64 of a conditional artifact
and G's output after the expand. Its body is train/sample.py's
``build_waves`` on those buffers: the function ``build_sample_fn`` runs.

On the card, at load (``replay``), on the sampler's own stream, once it
has waited for the caller's (the weights and buffers were made there):
  warm-up  one eager run of the body under a watch of every op and kernel
           call of the port (train/step_graph.py::_Watch). It builds
           every cache G makes at first use: the kernels' libraries, the
           shared-memory attribute a kernel above 48 KB sets at its first
           eager launch, K4's device plan, cuBLAS's handle and workspace.
  capture  the body once under ``torch.cuda.graph``
           (train/step_graph.py::_capture, the training step's machinery):
           each kernel call of the port notes its nodes, the capture's
           launches are taken back off the counters, and each port kernel
           must own one kernel node per counted launch (K4's host loop
           above batch 64 is captured as it is: ``check_kernel_nodes``).
  check    one replay on the warm-up's inputs, equal to its output to the
           bit.
A failure in any of them raises, naming the last op and kernel call; a
sampler on the card never serves eagerly because its capture failed.

Per request (``__call__``), under one lock, on the same stream: z drawn
into its buffer by a generator seeded with the request's seed (the call
``build_sample_fn`` makes: a capture can neither create nor replay a
fresh generator), the labels copied into theirs, the graph replayed and
its launches added to the counters (as ``StepGraph.replay``), the output
copied into a host tensor of the request's own, pinned on the card, that
the returned array keeps: the next request overwrites every fixed buffer,
never the caller's array. The pinned block comes from torch's caching
host allocator, which hands it out again once the array is dropped: a
fixed pinned buffer would need a host copy a request into fresh pages
(music's 45 MiB at batch 64 cost more than the request's device time
on an H100, PERF.md §6).

The tensor-core convs' TMA maps are encoded with their operands'
addresses and frozen into the graph's nodes, so the weights must stay the
tensors the graph was captured on: a sampler never swaps its weights, and
a new artifact is a new sampler.

Eager (the CPU, or ``replay=False`` on the card for the checks): the same
body on the same buffers, run for each request.
"""

from __future__ import annotations

import threading
from collections import Counter

import numpy as np
import torch

from audiogan_tpu_torch.config import Config
from audiogan_tpu_torch.kernels import hooks
from audiogan_tpu_torch.train.sample import build_waves, draw_latents
from audiogan_tpu_torch.train.step_graph import (_capture, _fill, _static,
                                                 _Watch, check_kernel_nodes,
                                                 differing, port_kernels,
                                                 take_back_launches)


class SampleGraph:
    """G at the artifact's batch on fixed buffers, replayed as one CUDA
    graph on the card (``route`` "replay") or run eagerly ("eager"); the
    module docstring."""

    def __init__(self, cfg: Config, params: dict[str, torch.Tensor],
                 num: int, device: torch.device, replay: bool = True):
        self.cfg, self.params, self.num = cfg, params, num
        self.device = device
        cuda = device.type == "cuda"
        self.route = "replay" if cuda and replay else "eager"
        n_cls = cfg.data.num_classes
        self.inputs = _static({
            "z": torch.empty(num, cfg.model.latent_dim),
            "labels": (torch.empty(num, dtype=torch.long) if n_cls
                       else None)}, device)
        self.stream = torch.cuda.Stream(device) if cuda else None
        self._waves = build_waves(cfg)
        self._lock = threading.Lock()
        self.graph = self.out = None
        self.nodes: list = []
        self.calls: list = []
        self.launch_delta: dict = {}
        self.capture_seconds = 0.0
        if self.route == "replay":
            self._capture()

    @torch.inference_mode()
    def body(self) -> torch.Tensor:
        return self._waves(self.params, self.inputs["z"],
                           self.inputs["labels"])

    def fill(self, seed: int, labels: np.ndarray | None) -> None:
        """z for ``seed`` and the labels into their buffers."""
        gen = torch.Generator(self.device).manual_seed(seed)
        draw_latents(self.cfg, gen, self.num, out=self.inputs["z"])
        if labels is not None:
            _fill(self.inputs["labels"], torch.from_numpy(labels), "labels")

    @torch.inference_mode()
    def _capture(self) -> None:
        # the weights and the fixed buffers were made on the caller's
        # stream, maybe just now (a fresh init's kernels still queued, a
        # buffer on memory whose last kernel has not run): the sampler's
        # stream waits for it
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            self.fill(0, None if self.inputs["labels"] is None
                      else np.zeros(self.num, np.int64))
            watch = _Watch(record_ops=False)
            try:
                with watch:
                    warm = self.body()
            except Exception as err:
                raise RuntimeError(f"the sampler's warm-up failed at "
                                   f"{watch.failed_at()}: {err}") from err
            warm = warm.clone()
            launches = hooks.launch_counts()
            (self.graph, self.nodes, self.calls, _, self.out,
             self.capture_seconds) = _capture(
                 self.body, self.device, False, "the sampler", self.stream)
            self.launch_delta = take_back_launches(launches)
            check_kernel_nodes(self.port_kernels(), self.launch_delta,
                               "the captured sampler")
            self.replay()
        self.stream.synchronize()
        if differing({"out": self.out}, {"out": warm}):
            raise RuntimeError("the sampler's replay differs from its eager "
                               "warm-up on the same inputs")

    def replay(self) -> torch.Tensor:
        """The graph replayed on the filled buffers; its launches counted."""
        self.graph.replay()
        hooks.add_launches(self.launch_delta)
        return self.out

    def __call__(self, seed: int, labels: np.ndarray | None) -> np.ndarray:
        """f32 [num, clip_len] for (seed, labels): int64 [num], or None for
        an unconditional artifact. The array is the caller's own."""
        with self._lock, torch.cuda.stream(self.stream), \
                torch.inference_mode():
            self.fill(seed, labels)
            y = self.replay() if self.route == "replay" else self.body()
            host = torch.empty(y.shape, dtype=y.dtype,
                               pin_memory=self.stream is not None)
            host.copy_(y, non_blocking=True)
            if self.stream is not None:
                self.stream.synchronize()
            return host.numpy()

    def port_kernels(self) -> dict:
        return port_kernels(self.nodes, self.calls)

    def summary(self) -> dict:
        """The route; under replay the capture's nodes by kind, port
        kernels and seconds."""
        if self.route != "replay":
            return {"route": self.route, "batch": self.num}
        return {"route": self.route, "batch": self.num,
                "nodes": len(self.nodes),
                "by_kind": dict(Counter(n["kind"] for n in self.nodes)),
                "port_kernels": self.port_kernels(),
                "capture_seconds": self.capture_seconds}
