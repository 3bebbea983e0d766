"""Typed configuration for the whole pipeline and for training (the port of
atvsnet_tpu/config.py).

Same fields and validation as atvsnet_tpu.config.PipelineConfig, minus one knob that
only means something on a TPU: scoped_vmem_kib (the Pallas kernel's VMEM budget). The
numerics fields are ported: the JAX package reads them from a trace-scoped policy
(atvsnet_tpu/numerics.py), the port passes them down explicitly.
  * act_quant (none|int8|int8s|int8mxu), act_quant_range and warp_quant (none|int8) as
    nn.layers.ActQuant and geometry.warp.plane_sweep_warp's quant; int8mxu's int8
    convolutions run on a CUDA kernel (ops.int8_conv);
  * fp32_precision (highest|high|default), the TPU's bf16 pass count for convolutions and
    matmuls with a float32 operand, as the `precision` argument of every nn.layers leaf
    (ops.fp32_passes: full fp32 with TF32 off; three bf16 passes; one). "high" and
    "default" run on the TF32 tensor cores on pre-rounded operands; each leaf call scopes
    the TF32 flags itself, so nothing process-wide changes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_SOFTARGMIN_IMPLS = ("auto", "cuda", "torch")
ACT_QUANT_MODES = ("none", "int8", "int8s", "int8mxu")
WARP_QUANT_MODES = ("none", "int8")
FP32_PRECISION_MODES = ("highest", "high", "default")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration, threaded explicitly through every model function."""

    # Number of input images: 1 reference + (view_num - 1) neighbor views.
    view_num: int = 5
    # Depth hypothesis planes in the sweep.
    max_d: int = 128
    # Maximum input image size (multiples of 32, so the 1/4-res volume is 8-divisible
    # for the 3-level 3D U-Nets).
    max_h: int = 480
    max_w: int = 896
    # Cost volume is built at this scale of the input image (FEM downsamples 4x).
    sample_scale: float = 0.25
    # Sweep in inverse depth (disparity).
    inverse_depth: bool = True
    batch_size: int = 1

    # --- numerics ---
    # dtype for conv compute; geometry, soft-argmin and normalization statistics
    # always run in float32.
    compute_dtype: str = "float32"
    # batch-norm epsilon (tf.layers.batch_normalization default).
    bn_eps: float = 1e-3
    # rematerialize per-pair stages under autograd; no effect on inference.
    remat: bool = False
    # Batch weight-shared sweeps through one set of CRM/refine convs: the two directions
    # of a pair in stage 1, all N-1 refinements in stage 3. The same math as the
    # sequential path (normalization statistics are per sample), at a higher peak
    # memory; PERF.md holds the measured seconds and bytes of both.
    pair_batch: bool = False
    # Soft-argmin implementation: "auto" launches the CUDA kernel for CUDA tensors and
    # uses the plain PyTorch version for CPU tensors; "cuda" / "torch" force one.
    softargmin_impl: str = "auto"
    # Reproduce the reference's per-pair visual-hull camera-indexing bug (the hull's
    # view term always reads camera 1); see models.tvsnet.refinement.
    reference_compat: bool = False
    # Storage quantization, inference only (round() has no gradient; the train CLI never
    # sets it). act_quant round-trips every 5D volume link (the conv_bn / deconv_bn /
    # conv3d_mixed_bn outputs) through an int8 lattice: "int8" with a per-tensor max-abs
    # scale, "int8s" with the static scale act_quant_range / 255 (relu links, uint8) or
    # / 127 (signed links); "int8mxu" stores as int8s and runs the volume convs whose input
    # is such a link (qin) on int8 operands with int32 sums. warp_quant="int8" stores the
    # bilinear plane-sweep volumes on a per-(sample, channel) int8 lattice scaled by the
    # source map's max.
    act_quant: str = "none"
    act_quant_range: float = 6.0
    warp_quant: str = "none"
    # The TPU's pass count for convolutions and matmuls whose operand is float32 (bf16 and
    # the int8mxu convs are untouched, and so are geometry and fusion, which stay full
    # fp32): "highest" full fp32 (6 bf16 passes on the TPU), "high" a_hi b_hi + a_hi b_lo +
    # a_lo b_hi with a_hi = bf16(a), a_lo = bf16(a - a_hi) and fp32 sums (3 passes),
    # "default" bf16-rounded operands with fp32 sums (1 pass). Forward and both gradients.
    fp32_precision: str = "highest"

    # --- fusion (reference depth_fusion.py defaults) ---
    prob_threshold: float = 0.8
    disp_threshold: float = 0.01
    num_consistent: int = 2
    fusion_depth_min: float = 0.01
    fusion_depth_max: float = 100000.0
    fusion_normal_threshold_deg: float = 360.0

    # --- network widths (reference cnn_wrapper/atvsnet.py) ---
    fem_base_filter: int = 32
    crm_base_filter: int = 8
    shallow_base_filter: int = 16
    refine_base_filter: int = 8

    def __post_init__(self):
        if self.max_d % 8 != 0:
            raise ValueError(f"max_d must be a multiple of 8, got {self.max_d}")
        if self.max_h % 32 != 0 or self.max_w % 32 != 0:
            raise ValueError(
                f"max_h/max_w must be multiples of 32, got {self.max_h}x{self.max_w}"
            )
        if self.view_num < 2:
            raise ValueError(f"view_num must be >= 2, got {self.view_num}")
        if self.compute_dtype not in _DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {sorted(_DTYPES)}, got {self.compute_dtype!r}"
            )
        if self.act_quant not in ACT_QUANT_MODES:
            raise ValueError(
                f"act_quant={self.act_quant!r}: expected one of {'|'.join(ACT_QUANT_MODES)}")
        if self.warp_quant not in WARP_QUANT_MODES:
            raise ValueError(
                f"warp_quant={self.warp_quant!r}: expected one of {'|'.join(WARP_QUANT_MODES)}")
        if self.fp32_precision not in FP32_PRECISION_MODES:
            raise ValueError(
                f"fp32_precision={self.fp32_precision!r}: expected one of "
                f"{'|'.join(FP32_PRECISION_MODES)}")
        if self.softargmin_impl not in _SOFTARGMIN_IMPLS:
            raise ValueError(
                f"softargmin_impl must be one of {_SOFTARGMIN_IMPLS}, got {self.softargmin_impl!r}"
            )

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training: the loss weights and the optimizer (atvsnet_tpu.config.TrainConfig, the
    same fields, defaults and validation)."""

    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    # Relative weights of the supervision terms on the initial (per-pair), aggregated
    # and refined depth maps.
    loss_weight_initial: float = 0.5
    loss_weight_agg: float = 1.0
    loss_weight_refined: float = 1.0
    grad_clip_norm: Optional[float] = 1.0
    # Peakiness term: adds loss_weight_confidence * (1 - mean 4-bin confidence of the
    # final depth over gt-valid pixels). Masked L1 on the expected depth is indifferent
    # to how concentrated the softmax is; this term keeps the confidence maps sharp.
    loss_weight_confidence: float = 0.0
    # 'constant', or 'cosine': linear warmup over warmup_steps, then cosine decay to
    # lr_final_fraction * learning_rate at decay_steps. The optimizer reads the step from
    # its own count, so a resumed run continues the schedule where it stopped.
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    decay_steps: int = 10_000
    lr_final_fraction: float = 0.01

    def __post_init__(self):
        if self.lr_schedule not in ("constant", "cosine"):
            raise ValueError(f"lr_schedule must be constant|cosine, got {self.lr_schedule!r}")
        if self.decay_steps <= 0:
            raise ValueError("decay_steps must be positive")
        if self.warmup_steps < 0:
            raise ValueError("warmup_steps must be >= 0")
        if self.loss_weight_confidence < 0:
            raise ValueError("loss_weight_confidence must be >= 0")
        if self.lr_schedule == "cosine" and self.warmup_steps >= self.decay_steps:
            # the decay horizon includes the warmup, as optax's does
            raise ValueError(
                f"warmup_steps ({self.warmup_steps}) must be < decay_steps "
                f"({self.decay_steps}): the cosine horizon includes the warmup"
            )
