"""The shared UNet noise-prediction backbone (counterpart of the
reference's ``models/unet.py``), eval and training paths.

Channel plan for base width C:
    down:   C → C → 2C → 2C(attn) → 4C        (each stage halves H, W)
    mid:    Res(4C) → Attn(4C) → Res(4C)
    up:     skip in, then 4C → 2C(attn) → 2C → C → C (each doubles H, W)

The public :meth:`UNet.forward` takes NHWC images, like the reference's
``apply``, and returns NHWC f32. Inside, activations are NCHW tensors in
``torch.channels_last`` memory, so the GroupNorm kernel reads each one as
a contiguous NHWC view.

Spatial parallelism (:meth:`UNet.set_row_group`): the rows of each
activation are split over the ranks of a spatial group
(``parallel/spatial.py``) by the reference's rule
(``_shard_activation``): after ``initial_conv``, after every down stage,
after ``mid_res2`` and after every up stage an activation of at least 8
rows is split and a smaller one whole; a stage whose input is split runs
on row blocks inside (halo convs, K1's split form, attention over the
gathered rows), a whole input whose stage output has at least 8 rows is
sliced after the stage, and the down conv that leaves fewer than 8 rows
gathers its input. The call still takes and returns whole images.
Under grad the down and up stages are checkpointed as on the whole
path, each rank's backward computes its output rows' share of the
gradients (``parallel/spatial.py``), and dropout's recompute draws the
forward's whole masks (from the saved CPU RNG state, or on CUDA from the
stage's ``RematRNG`` pair, which every rank of a group seeds alike).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..parallel import spatial
from .layers import (AttentionDownBlock, AttentionUpBlock, ConvDownBlock,
                     ConvUpBlock, GroupNormSiLU, ResidualBlock,
                     SelfAttentionBlock, SigmaEmbedding, SplitConv,
                     TimeEmbedding)
from .layers.resnet import conv_same

# flax's truncated-normal variance scaling divides the std by the std of a
# unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


class UNet(nn.Module):
    """Noise-prediction UNet.

    Args:
        in_channels: image channels (3 for RGB).
        model_channels: base width C.
        out_channels: output channels.
        num_heads: attention heads.
        dropout: ResidualBlock dropout rate (inactive in ``eval()``).
        num_classes: > 0 adds a label embedding whose extra last slot is
            the NULL token.
        conv_bias: give the bias-free convs a bias (imported reference
            checkpoints).
        continuous_sigma: condition on a continuous noise level σ through
            :class:`SigmaEmbedding` (the score network) instead of an
            integer timestep.
        split_skip_convs: consume each up stage's skip through split
            GroupNorm/convs where no group straddles the boundary (the
            default); false concatenates it first, as the reference's
            ``split_skip_convs: false``. Same parameters either way.
        remat: when gradients are recorded, checkpoint each down and up
            stage (recompute its forward in the backward), as the
            reference's ``nn.remat`` on ``down0…down4``/``up0…up4``; the
            mid blocks and the head are not checkpointed.
        remat_policy: what a checkpointed stage keeps (see
            :func:`resolve_remat_policy`); implies ``remat``.
    """

    def __init__(self, in_channels: int = 3, model_channels: int = 64,
                 out_channels: int = 3, num_heads: int = 4,
                 dropout: float = 0.0, num_classes: int = 0,
                 conv_bias: bool = False, remat: bool = False,
                 continuous_sigma: bool = False,
                 split_skip_convs: bool = True,
                 remat_policy: Optional[str] = None):
        super().__init__()
        c, temb = model_channels, model_channels * 4
        self.num_classes = num_classes
        self.remat = remat or remat_policy is not None
        self._remat_context = resolve_remat_policy(remat_policy)
        self._remat_rng = RematRNG() if dropout > 0.0 else None
        self.continuous_sigma = continuous_sigma
        self.time_embedding = (SigmaEmbedding(c, temb) if continuous_sigma
                               else TimeEmbedding(c, temb))
        if num_classes > 0:
            self.label_embedding = nn.Embedding(num_classes + 1, temb)
        self.initial_conv = nn.Conv2d(in_channels, c, 3, padding=1,
                                      bias=conv_bias)
        kw = dict(dropout=dropout, conv_bias=conv_bias)
        self.down0 = ConvDownBlock(c, c, temb, **kw)
        self.down1 = ConvDownBlock(c, c, temb, **kw)
        self.down2 = ConvDownBlock(c, 2 * c, temb, **kw)
        self.down3 = AttentionDownBlock(2 * c, 2 * c, temb,
                                        num_att_heads=num_heads, **kw)
        self.down4 = ConvDownBlock(2 * c, 4 * c, temb, **kw)
        self.mid_res1 = ResidualBlock(4 * c, 4 * c, temb, **kw)
        self.mid_attn = SelfAttentionBlock(4 * c, num_heads)
        self.mid_res2 = ResidualBlock(4 * c, 4 * c, temb, **kw)
        # Skips are the down stages' outputs, consumed in reverse order.
        kw["split_skip"] = split_skip_convs
        self.up0 = ConvUpBlock(4 * c, 4 * c, temb, skip_channels=4 * c, **kw)
        self.up1 = AttentionUpBlock(4 * c, 2 * c, temb,
                                    num_att_heads=num_heads,
                                    skip_channels=2 * c, **kw)
        self.up2 = ConvUpBlock(2 * c, 2 * c, temb, skip_channels=2 * c, **kw)
        self.up3 = ConvUpBlock(2 * c, c, temb, skip_channels=c, **kw)
        self.up4 = ConvUpBlock(c, c, temb, skip_channels=c, **kw)
        self.out_norm = GroupNormSiLU(c, 32)
        self.output_conv = nn.Conv2d(c, out_channels, 3, padding=1)
        self.row_group = None

    def set_row_group(self, group) -> None:
        """Split each activation's rows over the ranks of ``group`` (a
        ``parallel/spatial.py::RowGroup``; None: whole). Under grad each
        rank's backward gives its share of the gradients, which the
        trainer sums over the group."""
        self.row_group = group

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.initial_conv.weight.dtype

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, H, W, C_in] images; t: [B] integer timesteps (f32 noise
        levels σ with ``continuous_sigma``); y: optional [B] class labels.
        Returns the [B, H, W, C_out] f32 prediction."""
        if x.shape[1] < 32 or x.shape[2] < 32:
            raise ValueError(
                f"UNet needs spatial dims ≥ 32 (got {tuple(x.shape[1:3])}): "
                "the 5-stage downsampling path reaches zero size below "
                "that. Resize inputs to ≥ 32.")
        dtype = self.compute_dtype
        t_emb = self.time_embedding(t)
        if self.num_classes > 0:
            if y is None:
                y = torch.full(x.shape[:1], self.num_classes,
                               dtype=torch.long, device=x.device)
            t_emb = t_emb + self.label_embedding(y).to(t_emb.dtype)

        h = x.permute(0, 3, 1, 2).to(dtype).contiguous(
            memory_format=torch.channels_last)
        group = self.row_group
        if group is not None:
            return self._forward_rows(h, t_emb, group)
        h = self.initial_conv(h)
        stage = self._stage
        skips = []
        for i, block in enumerate((self.down0, self.down1, self.down2,
                                   self.down3, self.down4)):
            h = stage(i, block, h, t_emb)
            skips.append(h)
        h = self.mid_res1(h, t_emb)
        h = self.mid_attn(h)
        h = self.mid_res2(h, t_emb)
        for i, (block, skip) in enumerate(zip(
                (self.up0, self.up1, self.up2, self.up3, self.up4),
                reversed(skips))):
            h = stage(5 + i, block, h, t_emb, skip)
        h = self.output_conv(self.out_norm(h))
        return h.permute(0, 2, 3, 1).float()

    def _forward_rows(self, h: torch.Tensor, t_emb: torch.Tensor,
                      group) -> torch.Tensor:
        """:meth:`forward` from the NCHW input ``h`` with activations of at
        least ``MIN_ROWS`` rows split over ``group``'s ranks."""
        spatial.check_heights(h.shape[2], group.size)
        rows = h.shape[2]     # whole rows of the current activation

        def run(index, fn, h, *args, out_rows):
            """``fn`` on ``h`` (split when ``h`` has ≥ MIN_ROWS rows),
            through ``_stage`` (remat) for a down or up stage ``index``;
            the output of ``out_rows`` rows split by the same rule. The
            split is entered inside the checkpointed function, so the
            remat recompute runs split too."""
            split = rows >= spatial.MIN_ROWS

            def body(*a):
                with spatial.split(group if split else None):
                    return fn(*a)
            out = (body(h, *args) if index is None
                   else self._stage(index, body, h, *args))
            if not split and out_rows >= spatial.MIN_ROWS:
                out = group.slice(out)
            return out

        with spatial.split(group):
            h = conv_same(group.slice(h), self.initial_conv.weight,
                          self.initial_conv.bias)
        skips = []
        for i, block in enumerate((self.down0, self.down1, self.down2,
                                   self.down3, self.down4)):
            h = run(i, block, h, t_emb, out_rows=rows // 2)
            rows //= 2
            skips.append(h)
        for block in (self.mid_res1, self.mid_attn, self.mid_res2):
            h = run(None, block, h,
                    *(() if block is self.mid_attn else (t_emb,)),
                    out_rows=rows)
        for i, (block, skip) in enumerate(zip(
                (self.up0, self.up1, self.up2, self.up3, self.up4),
                reversed(skips))):
            h = run(5 + i, block, h, t_emb, skip, out_rows=2 * rows)
            rows *= 2
        with spatial.split(group):
            h = conv_same(self.out_norm(h), self.output_conv.weight,
                          self.output_conv.bias)
        return group.gather_output(h).permute(0, 2, 3, 1).float()

    def _stage(self, index: int, block: nn.Module, *args) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            # Non-reentrant checkpointing. On the CPU the recompute's
            # dropout masks are replayed from the saved RNG state
            # (preserve_rng_state); on CUDA, where saving that state cannot
            # be captured in a CUDA graph, from the stage's own pair of
            # generators (RematRNG), and a stage without dropout draws
            # nothing.
            fn, preserve = block, not args[0].is_cuda
            if not preserve and self._remat_rng is not None:
                fn = self._remat_rng.bind(index, block, args[0].device)
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=self._remat_context,
                              preserve_rng_state=preserve)
        return block(*args)

    def remat_generators(self):
        """The CUDA generators of the remat'd stages' dropout (registered
        with a CUDA graph that captures a training step)."""
        return [] if self._remat_rng is None else self._remat_rng.generators()

    def remat_rng_state(self):
        """The stages' dropout RNG state (host tensors), for
        :meth:`set_remat_rng_state`."""
        return None if self._remat_rng is None else self._remat_rng.state()

    def set_remat_rng_state(self, state) -> None:
        if self._remat_rng is not None and state is not None:
            self._remat_rng.set_state(state)


class RematRNG:
    """The dropout RNG of the checkpointed stages on CUDA, safe to capture
    in a CUDA graph.

    ``torch.utils.checkpoint`` replays a stage's dropout masks by saving
    the CUDA generator's state at the forward and restoring it for the
    recompute, which cannot be done inside a graph capture. Instead each
    stage draws its forward's masks from one generator and its
    recompute's from a second one with the same seed and offset: both
    advance by the same draws, so the recompute draws the forward's masks.
    The default generator is pointed at the stage's generator for the call
    (``graphsafe_set_state``), so ``nn.Dropout`` draws from it; the two
    generators of every stage are registered with a graph that captures a
    step, and a replay advances them as the eager steps would. Outside a
    capture the recompute's generator is set to the forward's before each
    forward, so a forward without a backward does not part them.

    The pairs are seeded from the default generator's seed (per stage),
    and seeded again when that seed changes (``torch.manual_seed``).
    """

    def __init__(self):
        self._pairs = {}
        self._seed = None

    def generators(self):
        return [g for pair in self._pairs.values() for g in pair]

    def state(self):
        """The seed and each stage's position, on the host."""
        return self._seed, {i: fwd.get_state()
                            for i, (fwd, _) in self._pairs.items()}

    def set_state(self, state) -> None:
        """Back to :meth:`state`: a stage that had drawn nothing then
        starts afresh."""
        self._seed, positions = state
        self._pairs = {i: pair for i, pair in self._pairs.items()
                       if i in positions}
        for i, position in positions.items():
            for g in self._pairs[i]:
                g.set_state(position)

    def bind(self, index: int, block: nn.Module, device: torch.device):
        """``block`` as the checkpointed function of stage ``index``: its
        first call (the forward) draws from the forward's generator, later
        calls (the recompute) from the recompute's."""
        default = torch.cuda.default_generators[
            device.index if device.index is not None
            else torch.cuda.current_device()]
        capturing = torch.cuda.is_current_stream_capturing()
        if not capturing and default.initial_seed() != self._seed:
            self._pairs.clear()
            self._seed = default.initial_seed()
        pair = self._pairs.get(index)
        if pair is None:
            if capturing:
                raise RuntimeError(
                    "a remat stage's dropout generators are made by an "
                    "eager step; run one before capturing a CUDA graph")
            seed = (self._seed * 1_000_003 + 7919 * (index + 1)) % 2 ** 63
            pair = self._pairs[index] = tuple(
                torch.Generator(device=device).manual_seed(seed)
                for _ in range(2))
        elif not capturing:
            pair[1].set_state(pair[0].get_state())
        calls = [0]

        def run(*args):
            gen = pair[min(calls[0], 1)]
            calls[0] += 1
            prev = default.graphsafe_get_state()
            default.graphsafe_set_state(gen)
            try:
                return block(*args)
            finally:
                default.graphsafe_set_state(prev)
        return run


def _save_convolutions(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op is torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def resolve_remat_policy(name: Optional[str]):
    """The ``context_fn`` of a checkpointed stage for the YAML
    ``remat_policy``.

    * ``None`` / ``"full"``: the default (no context); the backward
      recomputes the whole stage.
    * ``"save_convout"``: a selective checkpoint that keeps every
      ``aten.convolution`` output (the 3×3 and 1×1 convs with their bias,
      and the down- and up-sample convs) and recomputes the rest: the
      GroupNorm/SiLU (K1), attention (K3), the adds and the casts. The
      reference tags the conv outputs it keeps instead
      (``checkpoint_name(y, CONVOUT)``), after a split conv's sum; saving
      each ``aten.convolution`` keeps both halves of a split conv, so the
      port holds one more activation of the conv's width where a stage
      takes the skip connection. K1 and K3 are opaque to the dispatcher
      (one ``ctypes`` launch each), so the selective checkpoint never
      sees them and they rerun with the stage, as under ``"full"``.
    """
    if name is None or name == "full":
        return noop_context_fn
    if name == "save_convout":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_convolutions)
    raise ValueError(f"model_config.remat_policy must be 'full' or "
                     f"'save_convout', got {name!r}")


def remat_from_config(cfg) -> dict:
    """The UNet's ``remat`` and ``remat_policy`` keywords from a model
    config: ``remat`` (default on), turned on by any ``remat_policy``."""
    remat_policy = cfg.get("remat_policy")
    resolve_remat_policy(remat_policy)
    return {"remat": bool(cfg.get("remat", True)) or remat_policy is not None,
            "remat_policy": remat_policy}


def _trunc_normal_(w: torch.Tensor, fan_in: int, scale: float,
                   generator: torch.Generator) -> None:
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_unet_(net: UNet, generator: torch.Generator) -> UNet:
    """Initialize ``net`` in place as the reference's flax initializers do:
    LeCun-normal convs and Linears, He-normal ``initial_conv``,
    Xavier-uniform time MLP (LeCun-normal σ MLP), zero ``conv2``,
    ``time_proj`` and label embedding, zero biases, GroupNorm γ=1 and
    β=0."""
    xavier_mlp = not net.continuous_sigma
    for name, m in net.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(m, (SplitConv, nn.Conv2d, nn.ConvTranspose2d)):
            kh, kw = m.weight.shape[2:]
            # Conv2d and SplitConv weights are [O, I, kh, kw]; a transposed
            # conv's is [I, O, kh, kw]. fan_in counts I either way.
            fan_in = (m.weight.shape[0] if isinstance(m, nn.ConvTranspose2d)
                      else m.weight.shape[1]) * kh * kw
            if leaf == "conv2":
                m.weight.zero_()
            else:
                _trunc_normal_(m.weight, fan_in,
                               2.0 if leaf == "initial_conv" else 1.0,
                               generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            if leaf == "time_proj":
                m.weight.zero_()
            elif leaf in ("dense1", "dense2") and xavier_mlp:
                nn.init.xavier_uniform_(m.weight, generator=generator)
            else:
                _trunc_normal_(m.weight, m.weight.shape[1], 1.0, generator)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.zero_()
    return net


def cast_compute_dtype_(net: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast only the conv, Linear and embedding weights to ``dtype``.

    GroupNorm γ and β stay f32, as the reference keeps f32 parameters and
    casts the matmul operands at use; casting the whole module would round
    γ and β where the reference does not.
    """
    for m in net.modules():
        if isinstance(m, (SplitConv, nn.Conv2d, nn.ConvTranspose2d,
                          nn.Linear, nn.Embedding)):
            m.to(dtype)
    return net


__all__ = ["UNet", "init_unet_", "cast_compute_dtype_", "remat_from_config",
           "resolve_remat_policy"]
