"""int8 gradient compression with error feedback for the cross-pod link.

Twin of src/repro/train/grad_compress.py: per-tensor symmetric int8
quantization, the int8-wire mean over the pod axis (each pod's payload
1 byte an element instead of 4, dequantized and summed locally), and an
error-feedback residual carried in the training state so that the
quantization error is re-injected the next step (Karimireddy et al.,
EF-SGD).

The reference all_gathers the int8 payloads over the mesh's "pod" axis
under shard_map; here, as in core/moe_dispatch, the pods are a leading
batch axis: `compressed_pod_mean` takes each gradient stacked
(n_pod, ...) and returns the mean every pod would compute. Gradients are
mappings name -> tensor. "Per tensor" means per leaf of the reference's
pytree: the reference stacks the layers' parameters (L, ...), so the
layers of one parameter, `blocks.<i>.<key>`, share one scale here
(naming.layer_groups over the model's `.stacked` prefixes); xlstm's
layers are a list there, so each of its layers has its own scale.
"""
from __future__ import annotations

import torch

from repro_torch.models.naming import STACKED, layer_groups


def quantize_int8(x):
    """Per-tensor symmetric int8. Returns (q int8, scale float32)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.float() * scale


def _abs_max(tensors, dim=None):
    """The largest |x| over a leaf's tensors (over all but `dim` 0 when
    dim is 0: one value a pod)."""
    if dim is None:
        return torch.stack([t.abs().max() for t in tensors]).max()
    return torch.stack([t.abs().reshape(t.shape[0], -1).amax(dim=1)
                        for t in tensors]).amax(dim=0)


def compressed_pod_mean(grads, stacked=STACKED):
    """Mean gradients across the pod axis with the int8 wire format:
    grads name -> (n_pod, ...) tensor, one slice a pod; returns name ->
    (...) mean. Each pod quantizes each leaf with its own scale."""
    out = {}
    for names in layer_groups(grads, stacked).values():
        xs = [grads[n].float() for n in names]
        n_pod = xs[0].shape[0]
        scales = torch.clamp(_abs_max(xs, dim=0), min=1e-12) / 127.0
        for name, x in zip(names, xs):
            sc = scales.reshape((n_pod,) + (1,) * (x.ndim - 1))
            q = torch.clamp(torch.round(x / sc), -127, 127).to(torch.int8)
            out[name] = (q.float() * sc).sum(dim=0) / n_pod
    return out


@torch.no_grad()
def ef_compress_grads(grads, residual, stacked=STACKED):
    """Error feedback: g' = Q(g + r); r' = (g + r) - g'. A local transform
    (the end-to-end numerics of the compressed reduce). Returns
    (compressed grads, new residual)."""
    out, new_res = {}, {}
    for names in layer_groups(grads, stacked).values():
        corrected = [grads[n].float() + residual[n] for n in names]
        scale = torch.clamp(_abs_max(corrected), min=1e-12) / 127.0
        for name, c in zip(names, corrected):
            q = torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8)
            deq = dequantize(q, scale)
            out[name] = deq.to(grads[name].dtype)
            new_res[name] = c - deq
    return out, new_res


def init_residual(params):
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in dict(params).items()}
