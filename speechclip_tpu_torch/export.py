"""Export of the inference surfaces (port of speechclip_tpu/export.py):
``torch.export`` programs that run without the model code, the config
system or the checkpoint machinery.

- ``export_encode_speech``: wav / wav_len -> {parallel_audio_feat,
  cascaded_audio_feat, keywords} (whatever the config enables);
- ``export_encode_image``: normalized NHWC f32 images -> image_feat;
- ``export_encode_text``: token ids (+ EOT positions) -> text_feat;
- ``load_exported``: an artifact (a path or its bytes) -> a callable with
  the surface's return structure;
- ``encode_speech_surface`` (the surface the serving runtime calls) and
  ``cast_float_params`` (``--dtype bf16``).

An artifact is one ``torch.export.save`` file (``.pt2``) with the weights
baked in: a small module holds the params and state the surface reads as
buffers (those it does not read stay out of the file), so the file is
self-contained, as the JAX package's ``.stablehlo`` blob is. Shapes are
static per artifact, one artifact per (batch, wav length) serving shape;
``polymorphic_batch=True`` makes the batch a ``torch.export.Dim`` (min 1,
traced at a batch of 2 or more so that it is not specialized), so one
artifact serves any batch. The format is ``torch.export`` itself, not
AOTInductor or ``torch.compile``: those would regenerate the graph's own
ops and move rounding points. Each kernel is a node of the graph, the
custom op of ``kernels/_ops.py``, so a loaded artifact launches the
hand-written kernels on the card and runs the plain versions on the CPU;
loading needs only those op registrations. An artifact traced on one
device runs on another through ``load_exported(..., device=)``
(``torch.export.passes.move_to_device_pass``), unless its trace took a
branch that depends on the device: a bf16 convolution (HuBERT's conv
front end and positional conv, the ResNet image tower) sums through an
f32 upcast on the CPU and through cuDNN on the card, and the graph keeps
the traced branch, so such an artifact refuses another device type (JAX
lowers one artifact per platform instead).

    python -m speechclip_tpu_torch.export --ckpt <run>/ckpts/last --out exports/ \\
        --batch 32 --wav-samples 102400 272000 [--dtype bf16] [--platform cpu]
"""

from __future__ import annotations

import io
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

ARTIFACT_SUFFIX = ".pt2"
# the artifact's record beside the program (torch.export.save's extra_files)
_RECORD = "speechclip.json"


def encode_speech_surface(model):
    """``fn(params, state, wav, wav_len)``: ``model.encode_speech``'s
    tensors (``parallel_audio_feat``, ``cascaded_audio_feat``, ``keywords``,
    as the config enables them), ``vq_results`` dropped."""

    def fn(params, state, wav, wav_len):
        out = model.encode_speech(params, state, wav, wav_len)
        return {k: v for k, v in out.items() if k != "vq_results" and torch.is_tensor(v)}

    return fn


def cast_float_params(params: Any, dtype: torch.dtype) -> Any:
    """Every floating leaf to ``dtype`` (biases, LayerNorms and the text
    tower too, as the JAX function casts them); integer leaves and None
    stay. Not ``models.speechclip.cast_params``, which keeps vectors and the
    text tower in f32."""
    if isinstance(params, dict):
        return {k: cast_float_params(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(cast_float_params(v, dtype) for v in params)
    if torch.is_tensor(params) and params.is_floating_point():
        return params.detach().to(dtype)
    return params


class _Baked(torch.nn.Module):
    """``fn(*trees, *inputs)`` with the trees' tensors baked in as the
    buffers ``w{i}`` (a tensor that appears twice is one buffer)."""

    def __init__(self, fn: Callable, trees: Sequence):
        super().__init__()
        self._fn = fn
        leaves, self._spec = tree_flatten(list(trees))
        names: Dict[int, str] = {}
        # each leaf's buffer name, or None and the leaf kept as it is
        self._names: List[Optional[str]] = []
        self._consts: List[Any] = []
        for leaf in leaves:
            name = names.setdefault(id(leaf), f"w{len(names)}") if torch.is_tensor(leaf) else None
            if name and not hasattr(self, name):
                self.register_buffer(name, leaf.detach())
            self._names.append(name)
            self._consts.append(None if name else leaf)

    def forward(self, *inputs):
        values = [getattr(self, n) if n else c for n, c in zip(self._names, self._consts)]
        return self._fn(*tree_unflatten(values, self._spec), *inputs)


def _without_unread_buffers(program):
    """``program`` without the buffers its graph never reads (a surface
    reads part of the params tree: the speech surface not the image tower),
    so the artifact holds only the weights it runs."""
    from torch.export import ExportedProgram
    from torch.export.graph_signature import ExportGraphSignature

    signature = program.graph_signature
    module = program.graph_module
    unread = {n.name for n in module.graph.nodes
              if n.op == "placeholder" and n.name in signature.inputs_to_buffers and not n.users}
    if not unread:
        return program
    for node in [n for n in module.graph.nodes if n.name in unread]:
        module.graph.erase_node(node)
    module.recompile()
    specs = [s for s in signature.input_specs if s.arg.name not in unread]
    kept = {s.target for s in specs}
    return ExportedProgram(
        root=module, graph=module.graph,
        graph_signature=ExportGraphSignature(specs, signature.output_specs),
        state_dict={k: v for k, v in program.state_dict.items() if k in kept},
        range_constraints=program.range_constraints,
        module_call_graph=program.module_call_graph, example_inputs=None,
        constants=program.constants, verifiers=program.verifiers)


def _export(fn: Callable, trees: Sequence, example: Sequence[torch.Tensor],
            polymorphic_batch: bool) -> bytes:
    """Trace ``fn(*trees, *example)`` with ``torch.export`` (the batch of
    every input one ``Dim`` with ``polymorphic_batch``), keep the buffers
    the graph reads, and return the ``torch.export.save`` bytes (without
    the traced example inputs: a (32, 272000) f32 wav is 35 MB). The
    record beside the program names the device-dependent branches the
    trace took (``ops.basic.recording_device_branches``), which keep the
    artifact on its device type (``to_device``)."""
    from .ops.basic import recording_device_branches

    dynamic = None
    if polymorphic_batch:
        batch = torch.export.Dim("b", min=1)
        dynamic = {"inputs": tuple({0: batch} for _ in example)}
    with recording_device_branches() as branches:
        program = torch.export.export(_Baked(fn, trees), tuple(example),
                                      dynamic_shapes=dynamic, strict=False)
    program = _without_unread_buffers(program)
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={
        _RECORD: json.dumps({"device_branches": sorted(branches)})})
    return buf.getvalue()


def _example_batch(batch_size: int, polymorphic_batch: bool) -> int:
    """The traced batch: a polymorphic batch traces at 2 or more, since
    torch specializes a dimension whose example is 0 or 1."""
    return max(int(batch_size), 2) if polymorphic_batch else int(batch_size)


def _check_polymorphic_speech(model) -> None:
    """A chunked conv front end (``conv_batch_chunk``) branches on the
    batch size; JAX's export raises on that branch with a symbolic batch
    too (``InconclusiveDimensionOperation``)."""
    chunk = getattr(model.audio_cfg, "conv_batch_chunk", 0)
    if model.upstream is None and chunk:
        raise ValueError(
            f"polymorphic_batch: HuBERT's conv front end runs in chunks of {chunk} "
            "utterances when the batch exceeds that (conv_batch_chunk), a branch on the "
            "batch size that a symbolic batch cannot take; export a fixed batch, or a "
            "model with conv_batch_chunk 0 (the chunks change the memory, not the result)")


def export_encode_speech(model, params, state, batch_size: int, wav_samples: int,
                         device=None, polymorphic_batch: bool = False,
                         compact_wav: bool = False) -> bytes:
    """``model.encode_speech`` (``encode_speech_surface``) at a static
    (batch, wav) shape, or with ``polymorphic_batch`` a symbolic batch;
    the wav length stays static per artifact. ``compact_wav``: the artifact
    takes the wav as int16 PCM (the serving runtime's ``compact_wav``),
    else f32. ``device``: the device the trace's inputs lie on (the
    model's by default; params and state must lie there). -> the
    artifact's bytes (write them to disk as they are)."""
    if polymorphic_batch:
        _check_polymorphic_speech(model)
    device = model.device if device is None else torch.device(device)
    b = _example_batch(batch_size, polymorphic_batch)
    example = (torch.zeros((b, int(wav_samples)), device=device,
                           dtype=torch.int16 if compact_wav else torch.float32),
               torch.full((b,), int(wav_samples), dtype=torch.int32, device=device))
    return _export(encode_speech_surface(model), (params, state or {}), example,
                   polymorphic_batch)


def export_encode_image(model, params, batch_size: int, device=None,
                        polymorphic_batch: bool = False) -> bytes:
    """The image tower and its projection, for gallery encoding: normalized
    NHWC f32 images -> (B, E) features."""
    device = model.device if device is None else torch.device(device)
    size = model.vision_cfg.image_size
    b = _example_batch(batch_size, polymorphic_batch)
    example = (torch.zeros((b, size, size, 3), dtype=torch.float32, device=device),)
    return _export(lambda p, images: model.forward_image(p, images), (params,), example,
                   polymorphic_batch)


def export_encode_text(model, params, batch_size: int, device=None,
                       polymorphic_batch: bool = False) -> bytes:
    """The text tower: (B, context) int32 token ids (reduced ids under a
    reduced vocabulary) and (B,) int32 EOT positions -> (B, E) features."""
    device = model.device if device is None else torch.device(device)
    ctx = model.clip_cfg.context_length
    b = _example_batch(batch_size, polymorphic_batch)
    example = (torch.zeros((b, ctx), dtype=torch.int32, device=device),
               torch.zeros((b,), dtype=torch.int32, device=device))
    return _export(lambda p, text, eot: model.forward_text(p, text.long(), eot), (params,),
                   example, polymorphic_batch)


def program_device(program) -> torch.device:
    """The device an exported program's baked weights lie on."""
    for t in list(program.state_dict.values()) + list(program.constants.values()):
        if torch.is_tensor(t):
            return t.device
    raise ValueError("the exported program holds no tensor to read its device from")


def _same_device(a: torch.device, b: torch.device) -> bool:
    index = lambda d: d.index if d.index is not None else (
        torch.cuda.current_device() if d.type == "cuda" else None)
    return a.type == b.type and index(a) == index(b)


def device_branches(program) -> tuple:
    """The device-dependent branches an artifact's trace took (its record;
    none for a program this module did not export)."""
    return getattr(program, "_speechclip_device_branches", ())


def to_device(program, device):
    """``program`` on ``device``: itself where its weights already lie
    there, else moved by ``torch.export.passes.move_to_device_pass`` (the
    weights and the graph's device arguments). An artifact whose trace took
    a device-dependent branch (a bf16 convolution: upcast on the CPU, cuDNN
    on the card) raises on another device type, where its graph would not
    compute what a direct call there computes."""
    device = torch.device(device)
    source = program_device(program)
    if _same_device(source, device):
        return program
    branches = device_branches(program)
    if branches and source.type != device.type:
        raise ValueError(
            f"this artifact was traced on {source.type} through branches that depend on the "
            f"device ({', '.join(branches)}: a bf16 convolution sums through an f32 upcast on "
            f"the CPU and through cuDNN's bf16 convolution on the card); its graph keeps the "
            f"{source.type} branch, so on {device.type} it would not compute what a direct call "
            f"there computes. Export it on {device.type} (an f32 artifact moves)")
    from torch.export.passes import move_to_device_pass

    moved = move_to_device_pass(program, device)
    moved._speechclip_device_branches = branches
    return moved


def load_program(path_or_bytes, device=None):
    """An artifact (a path, a file object or its bytes) -> its
    ``torch.export.ExportedProgram``, on ``device`` where one is given
    (``to_device``). Imports the kernels' op registrations
    (``kernels/_ops.py``) and nothing of the model code."""
    from .kernels import _ops  # noqa: F401  (the ops the graph calls)

    if isinstance(path_or_bytes, (bytes, bytearray)):
        path_or_bytes = io.BytesIO(path_or_bytes)
    extra = {_RECORD: ""}
    program = torch.export.load(path_or_bytes, extra_files=extra)
    record = json.loads(extra[_RECORD]) if extra[_RECORD] else {}
    program._speechclip_device_branches = tuple(record.get("device_branches", ()))
    return program if device is None else to_device(program, device)


def load_exported(path_or_bytes, device=None) -> Callable:
    """An artifact -> a callable with the surface's return structure: a
    feature dict for speech, a tensor for image and for text. It runs on
    the artifact's device, or on ``device``."""
    return load_program(path_or_bytes, device).module()


def kernel_nodes(program) -> Dict[str, int]:
    """How many nodes of an exported graph (its submodules included) call
    each kernel op."""
    from .kernels._ops import op_name

    counts: Dict[str, int] = {}
    # regions under no_grad are submodules of the graph (higher-order ops)
    for module in program.graph_module.modules():
        if not isinstance(module, torch.fx.GraphModule):
            continue
        for node in module.graph.nodes:
            name = op_name(node.target) if node.op == "call_function" else None
            if name:
                counts[name] = counts.get(name, 0) + 1
    return counts


def main(argv: Optional[Sequence[str]] = None):
    """CLI: export serving artifacts from a checkpoint.

    python -m speechclip_tpu_torch.export --ckpt <run_dir_or_.ckpt> \\
        --out exports/ --batch 8 --wav-samples 102400 [--platform cpu]
    """
    import argparse

    parser = argparse.ArgumentParser(prog="python -m speechclip_tpu_torch.export")
    parser.add_argument("--ckpt", required=True,
                        help="a run checkpoint directory of the port or a reference Lightning .ckpt")
    parser.add_argument("--out", required=True)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument(
        "--wav-samples", type=int, nargs="+", default=[102400],
        help="one artifact per wav length (serving buckets): a single value writes "
             f"encode_speech{ARTIFACT_SUFFIX}, several write encode_speech@<n>{ARTIFACT_SUFFIX} "
             "each; the serving runtime routes a request to the smallest bucket that fits")
    parser.add_argument(
        "--platform", default="cuda",
        help="the one device the checkpoint is restored and traced on, and the artifacts' "
             "device: cuda (the default) or cpu")
    parser.add_argument("--polymorphic-batch", action="store_true")
    parser.add_argument("--dtype", default=None, choices=["bf16"],
                        help="cast every float weight before export (bf16 halves the artifact)")
    parser.add_argument("--compact-wav", action="store_true",
                        help="the speech artifacts take the wav as int16 PCM (half the bytes)")
    args = parser.parse_args(argv)

    device = args.platform
    if device not in ("cpu", "cuda"):
        raise SystemExit(
            f"--platform takes one device, cpu or cuda, got {device!r}: a bf16 artifact's conv "
            "front end keeps the branch of the device it was traced on, so it cannot move to "
            "the other (load_exported(..., device=) refuses it; an f32 artifact moves)")

    from .training.checkpoint import load_any_checkpoint

    model, params, state = load_any_checkpoint(args.ckpt, device=device)
    if args.dtype == "bf16":
        params = cast_float_params(params, torch.bfloat16)
    if args.polymorphic_batch:
        _check_polymorphic_speech(model)

    os.makedirs(args.out, exist_ok=True)
    poly = args.polymorphic_batch
    jobs = [("encode_speech" if len(args.wav_samples) == 1 else f"encode_speech@{n}",
             lambda n=n: export_encode_speech(model, params, state, args.batch, n,
                                              polymorphic_batch=poly,
                                              compact_wav=args.compact_wav))
            for n in args.wav_samples]
    jobs.append(("encode_image", lambda: export_encode_image(
        model, params, args.batch, polymorphic_batch=poly)))
    jobs.append(("encode_text", lambda: export_encode_text(
        model, params, args.batch, polymorphic_batch=poly)))
    for name, job in jobs:
        t0 = time.perf_counter()
        blob = job()
        path = os.path.join(args.out, name + ARTIFACT_SUFFIX)
        with open(path, "wb") as f:
            f.write(blob)
        print(f"wrote {path} ({len(blob) / 1e6:.1f} MB, exported in "
              f"{time.perf_counter() - t0:.1f} s on {device})", flush=True)


if __name__ == "__main__":
    main()
