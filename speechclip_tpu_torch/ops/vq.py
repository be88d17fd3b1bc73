"""Vector quantization over the CLIP subword vocabulary (port of
speechclip_tpu/ops/vq.py): special tokens are masked out of the (B, K, V)
cosine scores at f32 ``finfo.min``, and the codebook-usage diagnostics
(perplexities, per-keyword entropy, diversity loss) come with the result.
At eval the result is the argmax's one-hot, whatever ``hard`` and
``use_gumbel`` say. In train mode it is ``softmax(x / temp)``, or with
``use_gumbel`` ``softmax((x + g) / temp)`` with Gumbel noise ``g`` drawn
from the generator; with ``hard`` the forward value is the one-hot of its
argmax and the gradient the soft one's (straight-through:
``hard + soft - soft.detach()``). The temperature is fixed, learnable (a
parameter) or scheduled: ``max(max_t * decay ** num_updates, min_t)``.

Under data parallelism (a ``DataMesh``) the diagnostics' batch means
(``hard_probs``, ``avg_probs``, ``ent_per_t``) are the global batch's, as
in JAX's sharded step: one all-reduce of their sums, with its gradient,
since the diversity loss backpropagates through ``avg_probs``.
"""

from __future__ import annotations

import ast
from typing import Optional, Sequence, Tuple

import torch

from ..parallel.collectives import all_reduce_sum
from .basic import Params, rand_rows

MASK_VALUE = torch.finfo(torch.float32).min


def parse_temp_spec(temp) -> Tuple[str, tuple]:
    """-> (temp_type, payload): ``learnable=x`` / ``fixed=x`` -> (x,),
    ``"(max, min, decay)"`` -> the scheduled triple."""
    if isinstance(temp, (int, float)):
        return "fixed", (float(temp),)
    if not isinstance(temp, str):
        raise TypeError(f"temperature spec {temp!r}")
    if temp.startswith("learnable="):
        return "learnable", (float(ast.literal_eval(temp[len("learnable="):])),)
    if temp.startswith("fixed="):
        return "fixed", (float(ast.literal_eval(temp[len("fixed="):])),)
    triple = ast.literal_eval(temp)
    if len(triple) != 3:
        raise ValueError(f"temperature schedule {temp!r} is not (max, min, decay)")
    return "scheduled", tuple(float(t) for t in triple)


def vq_init(temp, device=None) -> Params:
    """Empty unless the temperature is learnable."""
    temp_type, payload = parse_temp_spec(temp)
    if temp_type == "learnable":
        return {"curr_temp": torch.tensor([payload[0]], dtype=torch.float32, device=device)}
    return {}


def current_temperature(params: Params, temp_spec,
                        num_updates: Optional[torch.Tensor] = None) -> torch.Tensor:
    temp_type, payload = parse_temp_spec(temp_spec)
    if temp_type == "learnable":
        return params["curr_temp"][0]
    if temp_type == "fixed":
        return torch.tensor(payload[0], dtype=torch.float32)
    max_t, min_t, decay = payload
    if num_updates is None:
        return torch.tensor(max_t, dtype=torch.float32)
    t = max_t * torch.pow(torch.tensor(decay, device=num_updates.device), num_updates.float())
    return torch.clamp(t, min=min_t)


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """-log(-log(u)) of f32 uniforms u in [1e-20, 1) from ``generator``
    (``rand_rows``: under data parallelism, the global batch's noise)."""
    u = rand_rows(shape, generator, generator.device)
    return -torch.log(-torch.log(u.clamp(min=1e-20)))


def vq_apply(
    params: Params,
    x: torch.Tensor,  # (B, K, V) cosine scores
    *,
    temp_spec,
    prob_mask: Sequence[int] = (0, 2, 3),
    use_gumbel: bool = False,
    hard: bool = True,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    num_updates: Optional[torch.Tensor] = None,
    ground_truth_perplexity: Optional[float] = None,
    mesh=None,
) -> dict:
    """-> the JAX package's result dict: subword_prob (f32; the one-hot at
    eval), targets (B, K, 1), code_perplexity, prob_perplexity, ent_per_t
    (K,), diversity_loss, temp, num_vars. ``mesh``: ``x`` is this rank's
    shard, the diagnostics the global batch's."""
    num_vars = x.shape[-1]
    x = raw = x.float()
    masked = torch.zeros(num_vars, dtype=torch.bool, device=x.device)
    if prob_mask:
        masked[list(prob_mask)] = True
        x = x.masked_fill(masked, MASK_VALUE)
    result = {"num_vars": num_vars}
    k = x.argmax(dim=-1)  # the first of equal maxima, as jnp.argmax
    hard_x = torch.nn.functional.one_hot(k, num_vars).float()
    soft = torch.softmax(x, dim=-1)
    ent = -(soft * torch.log(soft + 1e-9)).sum(dim=-1)  # (B, K)
    # the batch means as sums over the global batch (one all-reduce) / its size
    sums = all_reduce_sum(torch.cat([hard_x.reshape(-1, num_vars).sum(dim=0),
                                     soft.reshape(-1, num_vars).sum(dim=0), ent.sum(dim=0)]),
                          mesh, "vq")
    bsz = x.shape[0] * (mesh.world_size if mesh is not None else 1)
    rows = bsz * x.shape[1]
    hard_probs, avg_probs = sums[:num_vars] / rows, sums[num_vars:2 * num_vars] / rows
    result["code_perplexity"] = torch.exp(-(hard_probs * torch.log(hard_probs + 1e-7)).sum())
    result["prob_perplexity"] = torch.exp(-(avg_probs * torch.log(avg_probs + 1e-7)).sum())
    result["ent_per_t"] = sums[2 * num_vars:] / bsz
    temp = current_temperature(params, temp_spec, num_updates)
    result["temp"] = temp
    out = hard_x
    if train:
        # the specials are masked after the division: finfo.min / temp
        # overflows to -inf, whose product with a zero gradient is NaN in
        # the temperature's gradient; the softmax is the same either way
        if use_gumbel:
            if generator is None:
                raise ValueError("the Gumbel VQ needs a generator in train mode")
            logits = (raw + gumbel_noise(x.shape, generator)) / temp
            y_soft = torch.softmax(logits.masked_fill(masked, MASK_VALUE), dim=-1)
            y_hard = torch.nn.functional.one_hot(y_soft.argmax(dim=-1), num_vars).float()
        else:
            y_soft = torch.softmax((raw / temp).masked_fill(masked, MASK_VALUE), dim=-1)
            y_hard = hard_x
        out = y_hard + y_soft - y_soft.detach() if hard else y_soft
    result["subword_prob"] = out
    if ground_truth_perplexity is not None:
        result["diversity_loss"] = (
            (result["prob_perplexity"] - ground_truth_perplexity) ** 2
            / (num_vars - ground_truth_perplexity) ** 2
        )
    else:
        result["diversity_loss"] = (num_vars - result["prob_perplexity"]) / num_vars
    result["targets"] = (out.argmax(dim=-1) if train else k)[..., None]
    return result
