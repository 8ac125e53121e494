"""Expert parallelism: a mixture-of-experts layer over a mesh axis.

Counterpart of ``mxtpu/parallel/moe.py``: ``moe_apply`` (:25, top-1),
``moe_apply_topk`` (:111, top-k with GShard slot priority and
renormalized gates) and ``load_balancing_loss`` (:99, Switch's auxiliary
loss). The experts shard over the mesh axis ``axis_name``: device j holds
experts ``j*n_local .. (j+1)*n_local - 1`` (slices of ``expert_params``,
a dict of tensors whose leading axis is the expert). The tokens are
routed once, on ``x``'s device, into one dispatch buffer (n_experts,
capacity, d); device j gets its experts' queues (a copy of its slice of
the buffer), runs ``expert_fn(params, tokens)`` on them (tokens
(n_local, capacity, d)), and the outputs come back to ``x``'s device,
where the routing is undone. In mxtpu every device holds the replicated
tokens, routes them alike and exchanges its buffer by all-to-all, of
which only the source's queues are used; with the tokens on one device
that exchange is this scatter and gather. Capacity is fixed: a token
beyond an expert's ``capacity`` is dropped from it, and a token dropped
everywhere passes through unchanged. Gradients reach ``x``, the gate
logits and the expert parameters through autograd (the copies'
backward is the copy back).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .mesh import axis_devices, current_mesh

__all__ = ["moe_apply", "moe_apply_topk", "load_balancing_loss"]


def load_balancing_loss(gate_logits, choice_onehot):
    """Switch/GShard auxiliary loss ``n_experts * sum_e f_e * p_e``: f_e
    the fraction of decisions sent to expert e, p_e its mean gate
    probability."""
    probs = torch.softmax(gate_logits, dim=-1)
    n_experts = gate_logits.shape[-1]
    lead = tuple(range(choice_onehot.dim() - 1))
    f = choice_onehot.to(probs.dtype).mean(dim=lead)
    p = probs.mean(dim=tuple(range(probs.dim() - 1)))
    return n_experts * (f * p).sum()


def _slots(choice, n_experts):
    """Each decision's position in its expert's queue, in order."""
    onehot = torch.nn.functional.one_hot(choice, n_experts)
    return (onehot.cumsum(0) - 1).gather(1, choice[:, None])[:, 0]


def _experts(mesh, axis_name, expert_params, gate_logits):
    if mesh is None:
        mesh = current_mesh()
    devs = [c.torch_device for c in axis_devices(mesh, axis_name)]
    n_experts = gate_logits.shape[1]
    if n_experts % len(devs):
        raise MXNetError("%d experts do not split over %d devices"
                         % (n_experts, len(devs)))
    n_local = n_experts // len(devs)
    local = [{k: v[j * n_local:(j + 1) * n_local].to(dev)
              for k, v in expert_params.items()}
             for j, dev in enumerate(devs)]
    return devs, n_local, local


def _exchange(expert_fn, devs, local, disp, n_local):
    """The dispatch buffer (n_experts, cap, d) -> every expert's output,
    (n_experts, cap, d), on the buffer's device: each device's experts
    run on their slice of it."""
    outs = [expert_fn(p, disp[j * n_local:(j + 1) * n_local].to(dev))
            for j, (p, dev) in enumerate(zip(local, devs))]
    return torch.cat([o.to(disp.device) for o in outs])


def moe_apply(expert_fn, expert_params, gate_logits, x, mesh=None,
              axis_name="expert", capacity_factor=2.0):
    """Top-1 MoE: (tokens, d) -> (tokens, d), each kept token's expert
    output scaled by its gate probability, the others passed through."""
    devs, n_local, local = _experts(mesh, axis_name, expert_params,
                                    gate_logits)
    tokens, d = x.shape
    n_experts = gate_logits.shape[1]
    capacity = max(1, int(capacity_factor * tokens / n_experts))
    probs = torch.softmax(gate_logits.to(x.device), dim=-1)
    choice = probs.argmax(dim=-1)
    gate_p = probs.gather(1, choice[:, None])[:, 0]
    slot = _slots(choice, n_experts)
    keep = slot < capacity
    slot_c = slot.clamp(max=capacity - 1)
    disp = x.new_zeros((n_experts, capacity, d)).index_put(
        (choice, slot_c), torch.where(keep[:, None], x, 0.0),
        accumulate=True)
    got = _exchange(expert_fn, devs, local, disp, n_local)[choice, slot_c]
    return torch.where(keep[:, None], got * gate_p[:, None], x)


def moe_apply_topk(expert_fn, expert_params, gate_logits, x, k=2,
                   mesh=None, axis_name="expert", capacity_factor=2.0):
    """Top-k MoE: GShard priority (every token's first choice claims a
    slot before any second choice), gates renormalized over the chosen
    experts. Returns (out (tokens, d), the Switch auxiliary loss of the
    first choices)."""
    devs, n_local, local = _experts(mesh, axis_name, expert_params,
                                    gate_logits)
    tokens, d = x.shape
    n_experts = gate_logits.shape[1]
    capacity = max(1, int(capacity_factor * tokens * k / n_experts))
    gl = gate_logits.to(x.device)
    probs = torch.softmax(gl, dim=-1)
    topv, topi = probs.topk(k, dim=-1)
    weights = topv / topv.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    slot = _slots(topi.t().reshape(-1), n_experts).reshape(k, tokens).t()
    keep = slot < capacity
    slot_c = slot.clamp(max=capacity - 1)
    disp = x.new_zeros((n_experts, capacity, d))
    for j in range(k):
        disp = disp.index_put((topi[:, j], slot_c[:, j]),
                              torch.where(keep[:, j][:, None], x, 0.0),
                              accumulate=True)
    all_out = _exchange(expert_fn, devs, local, disp, n_local)
    combined = torch.zeros_like(x)
    for j in range(k):
        got = all_out[topi[:, j], slot_c[:, j]]
        combined = combined + torch.where(
            keep[:, j][:, None], got * weights[:, j][:, None], 0.0)
    routed = torch.where(keep.any(dim=1)[:, None], combined, x)
    aux = load_balancing_loss(gl, torch.nn.functional.one_hot(
        topi[:, 0], n_experts))
    return routed, aux
