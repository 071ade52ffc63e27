"""The WaveGAN critic with its channel axis split over the tp group, the
port of audiogan_tpu/parallel/tp_models.py.

``tp_discriminator_forward`` re-expresses the port's
``WaveGANDiscriminator`` forward, with the module's own parameters, as
the column/row pairing of parallel/tp.py: layers 0, 2, 4, ... are
column-parallel (this rank's slice of the output channels, no
exchange; the activations become channel-sharded), layers 1, 3, ... row-
parallel (this rank's slice of the input channels, one sum over tp,
then the bias and the activation in ``BiasAct``, whose double backward,
like the fused convs', does not run back through the layer's input);
LeakyReLU(0.2) after each. The phase shuffle takes the
same shifts on every rank, so the channel slicing commutes with it. The
dense head and the projection term: where the last layer is column-
parallel (an odd layer count, every preset), each rank contracts its
channel slice against the matching rows of ``head.kernel`` reshaped
[T_out, C, 1] (and of the label's embedding), with one sum over tp;
with an even count the features are whole and the plain head applies.
The score is the same on every rank and equals the unsharded module's.

As in the reference: the critic ignores ``model.fused_shuffle_sites``
(the select-form shuffle of the shifts it is given; K6 and K7 are not
on this path), and nothing is cast to ``train.dtype``: the reference's
function takes the f32 parameters as they are, so its tp step computes
the critic in f32 for a bf16 configuration, and so does this one (the
convs run K1/K1''s f32 CUDA-core kernels on the channel slices).

Which parameters are used through a slice, and which only after a sum
over tp, matters to the step (train/tp_step.py): ``sliced_params``.
"""

from __future__ import annotations

import torch

from audiogan_tpu_torch.kernels.autograd import BiasAct, as_compute
from audiogan_tpu_torch.models.wavegan import WaveGANDiscriminator
from audiogan_tpu_torch.ops.phase_shuffle import phase_shuffle
from audiogan_tpu_torch.parallel.halo import axis_sum
from audiogan_tpu_torch.parallel.mesh import TpMesh
from audiogan_tpu_torch.parallel.tp import (tp_conv1d_col, tp_conv1d_row,
                                            tp_slice)

F32 = torch.float32


def sliced_params(d: WaveGANDiscriminator) -> frozenset[str]:
    """The names of the critic's parameters that a rank uses only through
    its slice (each rank's gradient is its slice's share: the step sums
    them over tp): the column layers' kernels and biases, the row
    layers' kernels, and, when the last layer is column-parallel, the
    head's kernel and the projection embedding. The others (the row
    layers' biases, head.bias, and with an even layer count the head's
    kernel and proj_embed) are used after a sum, whole on every rank."""
    n = len(d.strides)
    names = {f"conv_{i}_kernel" for i in range(n)}
    names |= {f"conv_{i}_bias" for i in range(0, n, 2)}
    if n % 2:
        names.add("head.kernel")
        if d.num_classes:
            names.add("proj_embed.embedding")
    return frozenset(names)


def tp_discriminator_forward(d: WaveGANDiscriminator, x: torch.Tensor,
                             mesh: TpMesh,
                             shifts: torch.Tensor | None = None,
                             labels: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The score [B] of the critic ``d`` on x [B, T, 1] (the same on
    every rank), computed with this rank's channel slices, the same on
    every rank; shifts [L - 1, B] for the phase shuffle (None: none)."""
    n_layers = len(d.strides)
    h = as_compute(x, F32)
    sharded = False                 # h holds this rank's channel slice
    for i, s in enumerate(d.strides):
        w = as_compute(getattr(d, f"conv_{i}_kernel"), F32)
        b = as_compute(getattr(d, f"conv_{i}_bias"), F32)
        if sharded:
            h = BiasAct.apply(tp_conv1d_row(h, w, s, mesh), b, "leaky_relu",
                              0.2)
        else:
            h = tp_conv1d_col(h, w, b, s, mesh, act="leaky_relu", slope=0.2)
        sharded = not sharded
        if shifts is not None and d.rad and i < n_layers - 1:
            h = phase_shuffle(h, shifts[i], d.rad)
    bsz, t_out, c = h.shape
    kernel = as_compute(d.head.kernel, F32)
    if sharded:
        w_rows = tp_slice(kernel.reshape(t_out, c * mesh.size), 1, mesh)
        score = axis_sum(torch.einsum("btc,tc->b", h, w_rows), mesh)
    else:
        score = (h.reshape(bsz, -1) @ kernel)[:, 0]
    score = score + as_compute(d.head.bias, F32)[0]
    if d.num_classes:
        if labels is None:
            raise ValueError("conditional D needs labels")
        emb = as_compute(d.proj_embed.embedding, F32)[labels]
        pooled = h.mean(dim=1)
        if sharded:
            score = score + axis_sum(
                (pooled * tp_slice(emb, 1, mesh)).sum(-1), mesh)
        else:
            score = score + (pooled * emb).sum(-1)
    return score
