"""Serving bundles: a run's scoring program as a deployable file (port of
`vit_ad_tpu/serving/aot.py`).

The reference deploys by shipping `.pth` checkpoints that need the whole
model zoo at the serving site. A bundle is the program instead:
`torch.export` traces the same per-batch scoring function the evaluators run
(`pipeline/eval.make_*_batch_fn`, one code path, so a bundle's scores are the
evaluators' own) at a fixed batch, with the run's weights and normalisation
statistics in it, and `torch.export.save` writes it. Reloading needs torch
and numpy only: the host score tail is the dependency-light
`vit_ad_tpu_torch/scoring.py`, so no model code, registry, checkpoint
loading or conversion enters the serving site's imports (`score_files` adds
the data layer, to decode image files).

Artifact layout (one directory):

    manifest.json   kind / batch / img_size / platforms / provenance
    scorer.pt2      the exported program (uint8 [B,H,W,3] → payload)
    weights.npz     the parameters, with weights="external" only

The program is traced from a copy of the models with each compute-dtype
weight, folded BatchNorm and kernel operand made once as a buffer
(`models/layers.bake_compute_weights`), so it reads them as constants.
Portable (the default): the copy lies on the CPU, where every wrapper takes
its plain version, so the graph holds aten ops only and runs on the CPU or
the card; a bundle is moved to the serving device at load. Native
(`portable=False`): the copy lies on the card and the kernels stay in the
graph as the registered ops `vit_ad_tpu_torch::*` (`ops/cuda/library.py`);
it is served there, and the serving site imports the op module before the
program is read (`load_bundle` does).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import TYPE_CHECKING, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from vit_ad_tpu_torch.ops import gates

if TYPE_CHECKING:  # the model zoo: the export side only
    from vit_ad_tpu_torch.pipeline.loading import RunModels

MANIFEST_NAME = "manifest.json"
SCORER_NAME = "scorer.pt2"
WEIGHTS_NAME = "weights.npz"
PLATFORMS = ("cpu", "cuda")


def _device_of(m: "RunModels") -> torch.device:
    return next(m.parts[0].parameters()).device


def build_payload_fn_and_params(m: "RunModels", mean: Optional[np.ndarray] = None,
                                std: Optional[np.ndarray] = None
                                ) -> Tuple[Callable, Tuple[nn.Module, ...]]:
    """`(fn, modules)`: `fn(images_u8)` is the per-kind batch payload function
    (`pipeline/eval.make_*_batch_fn`, the evaluators' exact code path) on the
    models' device, `modules` the models whose parameters and buffers it
    reads, which an export bakes or takes as inputs. `mean`/`std` are the
    normalisation statistics (None: [0, 1] scaling only)."""
    from vit_ad_tpu_torch.pipeline import eval as E

    dev = _device_of(m)
    mean_t, std_t = (None if a is None else torch.as_tensor(a, dtype=torch.float32, device=dev)
                     for a in (mean, std))
    hp = m.hp
    if m.kind == "mdn":
        encoder, mdn = m.parts
        return E.make_mdn_batch_fn(encoder, mdn, hp, mean_t, std_t), (encoder, mdn)
    if m.kind == "nf":
        encoder, flow = m.parts
        return E.make_nf_batch_fn(encoder, flow, hp, mean_t, std_t), (encoder, flow)
    if m.kind == "recon":
        (model,) = m.parts
        return E.make_recon_batch_fn(model, mean_t, std_t), (model,)
    if m.kind == "mdn_resnet":
        encoder, heads = m.parts
        return E.make_mdn_resnet_batch_fn(encoder, heads, hp, mean_t, std_t), (encoder, heads)
    if m.kind == "nf_resnet":
        encoder, flows = m.parts
        return E.make_nf_resnet_batch_fn(encoder, flows, hp, mean_t, std_t), (encoder, flows)
    raise ValueError(f"unknown RunModels kind {m.kind!r}")


class _Payload(nn.Module):
    """The payload function as a module that returns tensors only (one, or a
    tuple per stage), with the models it reads as submodules, so that
    `torch.export` lifts their parameters and buffers."""

    def __init__(self, fn: Callable, models: Sequence[nn.Module],
                 tail: Optional[Callable] = None) -> None:
        super().__init__()
        self.models = nn.ModuleList(models)
        self.fn, self.tail = fn, tail

    def forward(self, images_u8: torch.Tensor):
        out = self.fn(images_u8)
        return out if self.tail is None else self.tail(out)


class _External(nn.Module):
    """`_Payload` with its parameters and buffers as inputs (`weights`, in
    `names` order). The payload is held outside the module tree, so that
    none of its tensors is saved in the program."""

    def __init__(self, payload: _Payload, names: List[str]) -> None:
        super().__init__()
        self._payload = (payload,)
        self.names = names

    def forward(self, weights: List[torch.Tensor], images_u8: torch.Tensor):
        return torch.func.functional_call(self._payload[0], dict(zip(self.names, weights)),
                                          (images_u8,))


def _named_tensors(module: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """Every parameter and buffer (non-persistent ones included) once."""
    return list(module.named_parameters()) + list(module.named_buffers())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy; numpy has no bf16, so a bf16 tensor keeps its 16-bit
    pattern (restored exactly by `_from_numpy`)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: str, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(a.copy())  # a copy keeps a 0-d array 0-d
    if dtype == "bfloat16":
        t = t.view(torch.int16).view(torch.bfloat16)
    return t.to(device)


def _ops_in(program) -> List[str]:
    """The registered kernel ops in the graphs (nested ones too) of an
    ExportedProgram or of the module a loaded one runs."""
    found = []
    for gm in getattr(program, "graph_module", program).modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                name = getattr(node.target, "name", None)
                if callable(name) and name().startswith(gates.NAMESPACE + "::"):
                    found.append(name())
    return found


def _drop_unread_state(ep: torch.export.ExportedProgram) -> None:
    """Remove from `ep` the parameters, buffers and constants its graph never
    reads: the originals of the baked weights (`_export_copy`), which a
    baked bundle would otherwise carry beside their compute-dtype copies."""
    from torch.export.graph_signature import ExportGraphSignature, InputKind

    state = (InputKind.PARAMETER, InputKind.BUFFER, InputKind.CONSTANT_TENSOR)
    sig, keep = ep.graph_signature, []
    placeholders = [n for n in ep.graph.nodes if n.op == "placeholder"]
    for spec, node in zip(sig.input_specs, placeholders):
        if spec.kind in state and not node.users:
            ep.graph.erase_node(node)
            (ep._state_dict if spec.target in ep._state_dict else ep._constants).pop(spec.target)
        else:
            keep.append(spec)
    ep._graph_signature = ExportGraphSignature(keep, sig.output_specs)
    ep.graph_module.recompile()
    ep.validate()


def _export_copy(m: "RunModels", device: torch.device) -> "RunModels":
    """The models as a bundle's program reads them: a copy on `device` (the
    caller's models stay as they are) with their compute-dtype weights,
    folded BatchNorms and kernel operands baked into buffers."""
    from vit_ad_tpu_torch.models.layers import bake_compute_weights

    parts = tuple(copy.deepcopy(p).to(device) for p in m.parts)
    for p in parts:
        bake_compute_weights(p)
    return dataclasses.replace(m, parts=parts)


def _run_padded(module: nn.Module, images: np.ndarray, batch: int, device: torch.device):
    """`module` over [N,H,W,3] uint8 in chunks of `batch` (the tail padded
    with repeats), payloads concatenated on the host and trimmed to N."""
    n = images.shape[0]
    pad = (-n) % batch
    if pad:
        images = np.concatenate([images, np.repeat(images[-1:], pad, axis=0)], axis=0)
    outs = []
    with torch.inference_mode():
        for s in range(0, n + pad, batch):
            out = module(torch.from_numpy(np.ascontiguousarray(images[s:s + batch])).to(device))
            outs.append([o.float().cpu().numpy() for o in (out if isinstance(out, tuple)
                                                           else (out,))])
    cat = tuple(np.concatenate(stage)[:n] for stage in zip(*outs))
    return cat if isinstance(out, tuple) else cat[0]


def export_bundle(
    m: "RunModels",
    out_dir: str,
    batch: int = 32,
    platforms: Optional[Sequence[str]] = None,
    portable: bool = True,
    mean: Optional[np.ndarray] = None,
    std: Optional[np.ndarray] = None,
    extra_meta: Optional[dict] = None,
    ref_images: Optional[np.ndarray] = None,
    weights: str = "baked",
    payload: str = "full",
) -> dict:
    """Export a run's scoring program as a serving bundle directory, from a
    copy of the models (on the CPU for a portable bundle, on the models'
    card for a native one).

    `platforms`: the devices the bundle may be served on ("cpu", "cuda");
    None = the models' device. A portable bundle takes either; a native one
    (`portable=False`, the kernels kept as ops) needs models on the card and
    takes "cuda" only.

    `weights`: "baked" (default) saves the parameters in the program;
    "external" makes them program inputs and writes them to `weights.npz`
    beside it (bf16 as its 16-bit pattern), so the program stays small and
    the weights can be diffed or re-signed without a new trace.

    `ref_images` (uint8 [N,H,W,3], e.g. the run's training images): for MDN
    kinds, their max log-likelihood, computed by this program, goes into the
    manifest as the bundle's fixed probability normalizer (with a scores
    payload, also into the program's tail), so scores compare
    across serving calls (without it, the reference's per-call-set
    normalization).

    `payload`: "full" (default) returns the evaluators' device payload (the
    anomaly maps, or the MDN log-likelihoods); "scores" folds the image-score
    tail into the program (`scoring.scores_tail`) and returns [B] floats;
    MDN kinds then need `ref_images`. Returns the manifest dict."""
    if batch < 1:
        raise ValueError("batch must be >= 1")
    if weights not in ("baked", "external"):
        raise ValueError(f"weights must be 'baked' or 'external', got {weights!r}")
    if payload not in ("full", "scores"):
        raise ValueError(f"payload must be 'full' or 'scores', got {payload!r}")
    device = _device_of(m)
    platforms = [str(p) for p in (platforms or [device.type])]
    if not set(platforms) <= set(PLATFORMS):
        raise ValueError(f"platforms must be among {PLATFORMS}, got {platforms}")
    if not portable:
        if device.type != "cuda" or not torch.cuda.is_available():
            raise ValueError("a native bundle carries the CUDA kernels as ops: export it from "
                             f"models on the card (they lie on {device}), or export portable")
        if platforms != ["cuda"]:
            raise ValueError(f"a native bundle is served on the card only; got platforms "
                             f"{platforms}")
    from vit_ad_tpu_torch.scoring import payload_ref_max_ll, scores_tail

    img = m.hp.img_size
    mdn = m.kind in ("mdn", "mdn_resnet")
    tail = None
    if payload == "scores" and not (mdn and ref_images is not None):
        tail = scores_tail(m.kind, img, None)  # MDN kinds raise: no normalizer
    on = torch.device("cpu") if portable else device
    fn, models = build_payload_fn_and_params(_export_copy(m, on), mean, std)
    images = torch.zeros((batch, img, img, 3), dtype=torch.uint8, device=on)

    def export(tail: Optional[Callable]):
        module, flat = _Payload(fn, models, tail), None
        if weights == "external":
            named = _named_tensors(module)
            flat = [t.detach() for _, t in named]
            module, args = _External(module, [n for n, _ in named]), (flat, images)
        else:
            args = (images,)
        with torch.no_grad():
            ep = torch.export.export(module, args, strict=False)
        _drop_unread_state(ep)
        return ep, flat

    ep, flat = export(tail)
    ref_max_ll = None
    if ref_images is not None and mdn:  # the normalizer, computed by the program itself
        program = ep.module()
        call = program if flat is None else (lambda x: program(flat, x))
        ref_max_ll = payload_ref_max_ll(m.kind, _run_padded(call, ref_images, batch, on))
        if payload == "scores":
            ep, flat = export(scores_tail(m.kind, img, ref_max_ll))
    found = _ops_in(ep)
    if portable and found:
        raise RuntimeError(f"a portable export traced kernel ops {sorted(set(found))}: a "
                           "wrapper launched on a CPU tensor")
    from torch._export.serde.schema import SCHEMA_VERSION

    os.makedirs(out_dir, exist_ok=True)
    manifest = {
        "kind": m.kind,
        "batch": batch,
        "img_size": img,
        "platforms": platforms,
        "portable": portable,
        "weights": weights,
        "payload": payload,
        "model_name": m.hp.model_name,
        "architecture": m.hp.architecture,
        "torch_version": torch.__version__,
        "export_schema_version": list(SCHEMA_VERSION),
        "exported_on": on.type,
        "kernel_ops": len(found),
    }
    if flat is not None:
        manifest["weight_dtypes"] = [str(t.dtype).removeprefix("torch.") for t in flat]
    if ref_max_ll is not None:
        manifest["ref_max_loglik"] = ref_max_ll
    if extra_meta:
        manifest.update(extra_meta)
    ep.example_inputs = None  # not saved: with external weights they are the weights
    torch.export.save(ep, os.path.join(out_dir, SCORER_NAME))
    if flat is not None:
        np.savez(os.path.join(out_dir, WEIGHTS_NAME),
                 **{f"w{i:05d}": _to_numpy(t) for i, t in enumerate(flat)})
    with open(os.path.join(out_dir, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ServingBundle:
    """A loaded serving bundle: pad → the program per chunk → host score
    tail. Needs torch and numpy (a native bundle also the op module
    `ops/cuda/library.py`, which this imports; `score_files` the data
    layer). `device`: where to serve ("cuda" unless the caller asks for the
    CPU); a portable bundle is moved there. As every entry point of the port,
    it sets the numerics policy (`config.set_numerics_policy`: no TF32 for
    f32 matmuls and convolutions), so a bundle computes as the evaluators."""

    def __init__(self, bundle_dir: str, device: str = "cuda") -> None:
        with open(os.path.join(bundle_dir, MANIFEST_NAME)) as f:
            self.manifest = json.load(f)
        self.kind: str = self.manifest["kind"]
        self.batch: int = int(self.manifest["batch"])
        self.img_size: int = int(self.manifest["img_size"])
        self.payload_kind: str = self.manifest.get("payload", "full")
        self.device = torch.device(device)
        if self.device.type not in self.manifest["platforms"]:
            raise ValueError(f"this bundle is for {self.manifest['platforms']}, not "
                             f"{self.device.type}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device here: serve this bundle with device='cpu'")
        from vit_ad_tpu_torch.config import set_numerics_policy

        set_numerics_policy()
        if not self.manifest["portable"]:
            import vit_ad_tpu_torch.ops.cuda.library  # noqa: F401  (the kernels' ops)
        ep = torch.export.load(os.path.join(bundle_dir, SCORER_NAME))
        if self.manifest.get("exported_on") != self.device.type:
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, self.device)
        self._program = ep.module()
        self._weights = None
        if self.manifest.get("weights") == "external":
            npz = np.load(os.path.join(bundle_dir, WEIGHTS_NAME))
            self._weights = [_from_numpy(npz[k], dt, self.device)
                             for k, dt in zip(sorted(npz.files), self.manifest["weight_dtypes"])]

    def _call(self, images_u8: torch.Tensor):
        if self._weights is not None:
            return self._program(self._weights, images_u8)
        return self._program(images_u8)

    def payloads(self, images_u8: np.ndarray):
        """The concatenated payloads (f32, on the host) of [N,H,W,3] uint8
        images, N >= 1 (the tail chunk padded with repeats and trimmed)."""
        if images_u8.ndim != 4:
            raise ValueError(f"bundle expects [N,{self.img_size},{self.img_size},3] uint8 "
                             f"images, got {images_u8.shape}")
        n, h, w, c = images_u8.shape
        if n == 0:
            raise ValueError("no images to score (got a [0,H,W,3] array — empty folder?)")
        if (h, w, c) != (self.img_size, self.img_size, 3) or images_u8.dtype != np.uint8:
            raise ValueError(f"bundle expects [N,{self.img_size},{self.img_size},3] uint8 "
                             f"images, got {images_u8.dtype} {images_u8.shape}")
        return _run_padded(self._call, images_u8, self.batch, self.device)

    def score(self, images_u8: np.ndarray,
              normalizer: str = "auto") -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """[N,H,W,3] uint8 → (image_scores [N], pixel_scores [N,H,W]) with the
        matching evaluator's score semantics.

        `normalizer` (MDN kinds): "auto" uses the baked reference max
        log-likelihood where the manifest carries one, so scores compare
        across calls; "call" takes the reference's per-call-set
        normalization (the evaluators' own: an image's score then depends on
        the rest of its wave). A scores-only bundle computed the image score
        in the program and returns (image_scores, None)."""
        from vit_ad_tpu_torch.scoring import payload_to_scores

        if normalizer not in ("auto", "call"):
            raise ValueError(f"normalizer must be 'auto' or 'call', got {normalizer!r}")
        if self.payload_kind == "scores":
            return np.asarray(self.payloads(images_u8)), None
        ref = self.manifest.get("ref_max_loglik") if normalizer == "auto" else None
        return payload_to_scores(self.kind, self.payloads(images_u8), self.img_size,
                                 ref_max_ll=ref)

    def score_files(self, paths: Sequence[str]) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Decode and resize image files through the data layer, then score."""
        return self.score(decode_files(paths, self.img_size, self.batch))


def decode_files(paths: Sequence[str], img_size: int, batch: int = 32) -> np.ndarray:
    """[N, img_size, img_size, 3] uint8 of image files, decoded as the
    evaluators decode them (`data/loader.DataPipeline`)."""
    from vit_ad_tpu_torch.data.loader import DataPipeline

    pipe = DataPipeline(batch_size=batch, img_size=img_size, files=list(paths))
    return np.concatenate([b.images[: int(b.valid.sum())] for b in pipe.test_batches(0)])


def load_bundle(bundle_dir: str, device: str = "cuda") -> ServingBundle:
    return ServingBundle(bundle_dir, device)
