"""Configuration dataclasses of the solve path.

A copy of the fields of `globalegomocap_tpu/config.py` that the optimizer
and the trainer read, with the same names and defaults, so one set of
values configures both packages.  Every option runs, solver.init =
'sample' included (JAX's own threefry draw, `ops/random.py`); a value
neither package knows is refused by name (optimize/pipeline.py
`check_supported`).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class WindowConfig:
    seq_len: int = 10
    overlap: int = 2

    @property
    def stride(self) -> int:
        return self.seq_len - self.overlap


@dataclass(frozen=True)
class SolverConfig:
    """Latent solver settings (reference torch LBFGS: lr 2, max_iter 25)."""
    method: str = "lbfgs"          # 'lbfgs' | 'lbfgs_fixed' | 'adam'
    lr: float = 2.0
    max_iter: int = 25
    history_size: int = 25
    tolerance_change: float = 1e-6
    tolerance_grad: float = 1e-7
    max_ls_evals: int = 25
    adam_steps: int = 150
    adam_lr: float = 0.05
    init: str = "mu"                # 'mu' | 'sample'
    init_seed: int = 0
    step_candidates: tuple = (1.0, 0.5, 0.1, 0.02)
    fused_probes: bool = False
    compact_direction: bool = False
    circular_history: bool = False
    pallas_direction: bool = False
    remat: bool = False
    # one fused kernel per objective eval (ops/fused_energy.py) under the
    # explicitly batched solver
    fused_energy: bool = False
    batched_solver: bool = False
    fused_decode: bool = False
    # scan unroll factor of the JAX solver; the port's iteration loop is a
    # Python loop, so this has no meaning here and is ignored by design
    unroll: int = 1
    # stage-2 (global) iteration override; None = max_iter
    global_max_iter: int | None = None


@dataclass(frozen=True)
class EnergyConfig:
    """CLI-level energy weights; the stage rescalings are applied by
    optimize/pipeline.py `stage_weights`."""
    vae: float = 0.0
    gmm: float = 0.0
    smooth: float = 0.001
    bone_length: float = 0.01
    weight_3d: float = 0.01
    reproj: float = 0.01
    soft_smooth: float = 0.0
    overlap_consistency: float = 0.0
    global_weight_3d: float | None = None
    global_smooth: float | None = None
    # stage-2 output p(z) = mid + decode(z) - decode(z0): exact at init
    global_residual: bool = False
    local_residual: bool = False


@dataclass(frozen=True)
class HeatmapGeometry:
    """64x64 heatmaps predicted on the 1024x1024 centre crop of the
    1280x1024 fisheye image: x shifts by -crop_offset, coordinates
    normalise by (p - half) / half."""
    crop_offset: float = 128.0
    half_extent: float = 512.0


@dataclass(frozen=True)
class PriorConfig:
    latent_dim: int = 2048
    seq_len: int = 10
    hidden_dims: tuple = (64, 64, 128, 256, 512)
    in_channels: int = 45


@dataclass(frozen=True)
class OptimizeConfig:
    window: WindowConfig = field(default_factory=WindowConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    energy: EnergyConfig = field(default_factory=EnergyConfig)
    prior: PriorConfig = field(default_factory=PriorConfig)
    heatmap: HeatmapGeometry = field(default_factory=HeatmapGeometry)
    camera: str = "egosyn"
    sampling_impl: str = "gather"
    # staged heat-crop storage dtype; the kernel math stays float32
    heatmap_dtype: str = "float32"
    # k x k peak crops staged per map (0 = full maps)
    heatmap_crop: int = 0
    fold_bn: bool = False
    dense_decoder: bool = False
    decoder_impl: str = ""
    decoder_dtype: str = "float32"
    final_smooth: bool = True
    final_smooth_sigma: float = 1.0
    final_smooth_method: str = "gaussian"
    input_smooth_sigma: float = 1.0
    # crop-mass guard: below this mean coverage the crops are redone
    heatmap_crop_min_mass: float = 0.90
    robust_tier_on_guard: bool = True
    # guard-trip fast path: k=guard_crop crops centred at the projected
    # initial estimate (0 = full-map fallback)
    guard_crop: int = 0
    crop_center: str = "peak"       # 'peak' | 'estimate'
    merge: bool = True
    matmul_merge: bool = True
    compute_dtype: str = "float32"
    stage_segment_chunks: int = 384
    stage_crop_impl: str = "onehot"


@dataclass(frozen=True)
class TrainConfig:
    """VAE training settings (reference: networks/config.py + the four
    launch .sh scripts: latent 2048, kl 0.5, seq 10, batch 64, fps 25)."""
    train_data_path: str = ""
    latent_dim: int = 2048
    seq_length: int = 10
    fps: int = 25
    kl_weight: float = 0.5
    epochs: int = 20
    batch_size: int = 64
    learning_rate: float = 1e-4
    # 'constant' (the reference's fixed-lr Adam) or 'cosine' (linear
    # warmup, then cosine decay to lr_final over the run)
    lr_schedule: str = "constant"
    lr_warmup_steps: int = 0
    lr_final: float = 0.0
    # initial bias of the VAE's log-variance head (ConvVAE.logvar_bias_init):
    # negative values start the posterior near-deterministic
    logvar_init_bias: float = 0.0
    # compute dtype of the encoder/decoder: 'bfloat16' runs their products
    # in bf16 while the parameters, the optimizer state and the loss stay
    # float32
    compute_dtype: str = "float32"
    weight_decay: float = 0.0
    slide_window_step: int = 1
    data_balance: bool = False
    with_mo2cap2_data: bool = False
    local_pose: bool = False        # local-pose VAE vs relative-global VAE
    log_dir: str = "logs"
    log_step: int = 100
    seed: int = 0
    # 0 = all available; the port trains on one card (ROADMAP §A item 4)
    num_devices: int = 0
    # run each epoch in blocks of scan_block steps with no host readback
    # inside a block (JAX: one lax.scan launch a block); same math and
    # batch order as the per-step loop, log_step granularity per epoch
    epoch_scan: bool = False
    # epoch_scan's block: at most this many steps; a trailing block of
    # two or more steps runs as a block, a single leftover step alone
    scan_block: int = 256
    # evaluate (and checkpoint) every N epochs, always on the last
    eval_every: int = 1


def with_overrides(cfg, **kwargs):
    """Functional update helper for frozen configs."""
    return replace(cfg, **kwargs)
