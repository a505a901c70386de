"""Configuration dataclasses and the numerics policy.

Port of `vit_ad_tpu/config.py` (:16-115, `to_log_dict` :111): the same fields and defaults, with
torch dtypes in `DtypePolicy`. `set_numerics_policy` pins the f32 behaviour of
the CUDA libraries, which the JAX package never had to state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

# ImageNet statistics, identical values to reference src/util/ModelHelper.py:5-6.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def set_numerics_policy() -> None:
    """Full f32 for f32 matmuls and convolutions on the card. cuDNN runs f32
    convolutions in TF32 by default (about three decimal digits), which would
    silently diverge from the JAX flow's full-f32 convs; the entry points
    (`cli/score.main`, `chip_smoke.py`) call this first."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def check_device(device: str) -> str:
    """The requested device, or exit: a CUDA device without a card is an
    error, never a quiet fall back to the CPU (the CLIs and the sweep)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: no CUDA device is available; give --device cpu "
                         "explicitly to run on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Numeric policy: params are kept in `param_dtype`, matmuls/convs run in
    `compute_dtype` (bf16 feeds the tensor cores), reductions and losses
    accumulate in `accum_dtype`."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32

    @staticmethod
    def f32() -> "DtypePolicy":
        return DtypePolicy(compute_dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh (`vit_ad_tpu/config.py:36-62`): `data` shards the
    batch, `model` shards the MDN heads' mixture components (`parallel/`).
    A size of -1 means "every remaining rank". The default (1, 1) requests no
    mesh: the trainers and evaluators run in one process on one device."""

    data: int = 1
    model: int = 1
    axis_names: Sequence[str] = ("data", "model")

    @property
    def requested(self) -> bool:
        """True when an axis asks for more than one rank (or for all)."""
        return self.data != 1 or self.model != 1

    @staticmethod
    def parse(spec: str) -> "MeshConfig":
        """A CLI mesh spec: 'DxM' (e.g. '4x2'), a bare data size ('8'), or
        'auto' (every rank on the data axis)."""
        spec = spec.strip().lower()
        if spec in ("auto", "all"):
            return MeshConfig(data=-1, model=1)
        if "x" in spec:
            d, m = spec.split("x", 1)
            return MeshConfig(data=int(d), model=int(m))
        return MeshConfig(data=int(spec), model=1)


@dataclasses.dataclass
class HyperParams:
    """Training hyper-parameters. Field names follow the reference's
    HyperParameterConfig (reference src/pipeline/LearnerRecon.py:23-52) so CLI
    plumbing and logged configs stay comparable with the JAX package."""

    # Model selection (registry keys).
    model_name: str = "ae_cnn"
    architecture: str = "reconstruction"  # reconstruction | mdn | nf
    # Optimization.
    epochs: int = 50
    patience: int = 30
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    batch_size: int = 64
    # Data.
    base_path: str = "data/mvtec"
    train_pref: str = "train/good"
    valid_path: Optional[str] = None
    test_path: Optional[str] = None
    img_size: int = 224
    amount_data: int = 0
    centering: bool = False
    dataset: str = "mvtec"
    data_class: str = ""
    # Head-specific.
    num_gaussians: int = 150          # MDN (reference startTraining_mdn.py:33)
    kmeans_init: bool = False
    hidden_ratio: float = 0.16        # NF  (reference startTraining_NF.py:35)
    flow_steps: int = 20              # NF  (reference startTraining_NF.py:36)
    block_index: int = 0              # transformer feature depth (0 = last)
    # LayerNorms through the one-pass kernel, for the trunks that have the
    # path (None: the model's default; the JAX package's VITAD_PALLAS_LN)
    fused_ln: Optional[bool] = None
    # the ViT/DeiT blocks' MLP tail through the fused kernel (None: the
    # model's default; the JAX package's VITAD_PALLAS_MLP)
    fused_mlp: Optional[bool] = None
    # Loss weights for the SSIM recon variant (reference LearnerRecon.py:278).
    mse_weight: float = 5.0
    ssim_weight: float = 0.5
    # Eval.
    fp_threshold: float = 0.3
    # Reproducibility / execution.
    seed: int = 24                    # matches reference file-shuffle seed
    dtypes: DtypePolicy = dataclasses.field(default_factory=DtypePolicy)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    cache_frozen_features: bool = True
    prefetch: int = 2
    log_dir: str = "runs"
    enable_wandb: bool = False

    def to_log_dict(self) -> dict:
        """The fields a run directory's `config.json` records (JAX
        `to_log_dict` :111): all but the dtype policy and the mesh, so a
        restored run scores on one device under the default policy."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name not in ("dtypes", "mesh")}
