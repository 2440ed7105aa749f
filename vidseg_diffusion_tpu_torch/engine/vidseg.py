"""The VidSeg engine (PyTorch): harvest pass and modulated runs.

Counterpart of vidseg_diffusion_tpu/engine/vidseg.py for the single-device
path: HarvestSpec / svd_harvest_spec / sd_harvest_spec, the DDIM inversion of
the clean latent (`invert`), the feature/x_t pass that harvests
attention q/k and the post-step latent trajectory (`xt_cache_pass`, with the
windowed cache contract: entries are indexed [i - t0] with t0 = cache["t0"]),
and the (mask, +/-lambda) runs grid, runs outer and stepped, with latent
blending and an `on_run_done` hook (the counterpart of
modulated_runs_host_stepped's runs-outer branch, :1000-1018), on one process
or split over the ranks of a process group (modulated_runs_sharded's
counterpart, parallel/runs.py). With
is_injected_features the feature pass also keeps the temporal self-attention
q and k of the attention-bearing output blocks, and every modulated run
replaces the computed q/k of those sites by the cached ones from the first
modulated step on; with the image UNet (SD 2.1) the injected features are
the spatial self- and cross-attention q and k instead. The cache stays on the device (the JAX package's host-RAM
streaming is a TPU workaround and is not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from vidseg_diffusion_tpu_torch.diffusion.denoiser import Denoiser
from vidseg_diffusion_tpu_torch.diffusion.guidance import LinearPredictionGuider, VanillaCFG
from vidseg_diffusion_tpu_torch.diffusion.sampling import EulerEDMSampler
from vidseg_diffusion_tpu_torch.engine.modulation import ModulationConfig
from vidseg_diffusion_tpu_torch.models.layers import (
    AttnInjection,
    BlockInjection,
    BlockModulation,
    Modulation,
)
from vidseg_diffusion_tpu_torch.models.unet import UNetHooks, UNetModel
from vidseg_diffusion_tpu_torch.models.video_layers import SiteInjection, SiteModulation
from vidseg_diffusion_tpu_torch.ops.image import resize_nearest
from vidseg_diffusion_tpu_torch.parallel.runs import all_gather_runs, all_reduce_sum, runs_of_rank

Cond = Dict[str, torch.Tensor]

# harvest site -> (child module, attention) inside output_blocks_{i}_1
_SITES = {
    "spatial_self": ("transformer_blocks_0", "attn1"),
    "spatial_cross": ("transformer_blocks_0", "attn2"),
    "temporal_self": ("time_stack_0", "attn1"),
    "temporal_cross": ("time_stack_0", "attn2"),
}


@dataclasses.dataclass(frozen=True)
class HarvestSpec:
    """Which attention tensors the feature pass keeps: (block, site, tensor)
    with site in _SITES and tensor in {q, k}."""

    entries: Tuple[Tuple[int, str, str], ...] = ()

    @staticmethod
    def name(block: int, site: str, tensor: str) -> str:
        return f"output_{block}_{site}_{tensor}"

    @property
    def blocks(self) -> Tuple[int, ...]:
        return tuple(sorted({b for b, _, _ in self.entries}))

    def extract(self, intermediates: Dict) -> Dict[str, torch.Tensor]:
        out = {}
        for block, site, tensor in self.entries:
            child, attn = _SITES[site]
            out[self.name(block, site, tensor)] = intermediates[f"output_blocks_{block}_1"][child][attn][tensor]
        return out


def svd_harvest_spec(cluster_blocks: Sequence[int] = (8,), injection: bool = False,
                     injection_blocks: Sequence[int] = tuple(range(3, 12))) -> HarvestSpec:
    """Spatial self-attention q of the clustering blocks; with `injection`,
    also the temporal self-attention q and k of the attention-bearing output
    blocks (the only injected features the SVD path ever consumes)."""
    entries = [(b, "spatial_self", "q") for b in cluster_blocks]
    if injection:
        for b in injection_blocks:
            entries.append((b, "temporal_self", "q"))
            entries.append((b, "temporal_self", "k"))
    return HarvestSpec(tuple(entries))


def sd_harvest_spec(cluster_blocks: Sequence[int] = (7,), injection: bool = False,
                    injection_blocks: Sequence[int] = tuple(range(3, 12))) -> HarvestSpec:
    """SD 2.1: spatial self-attention q of the clustering blocks; with
    `injection`, the spatial self- and cross-attention q and k of the
    attention-bearing output blocks (sd_pipeline_vspw.py:421-428)."""
    entries = [(b, "spatial_self", "q") for b in cluster_blocks]
    if injection:
        for b in injection_blocks:
            for site in ("spatial_self", "spatial_cross"):
                entries.append((b, site, "q"))
                entries.append((b, site, "k"))
    return HarvestSpec(tuple(entries))


def _cache_step(cache: Dict, name: str, i: int) -> torch.Tensor:
    """A (possibly windowed) step cache at absolute step i: entries are
    indexed [i - t0] with t0 = cache["t0"] (absent: full length). The index
    is clipped; gating keeps out-of-window values from being consumed."""
    arr = cache[name]
    return arr[min(max(i - int(cache.get("t0", 0)), 0), arr.shape[0] - 1)]


def _injection_site_for_block(block: int, cache: Dict, i: int, gate: torch.Tensor, video: bool
                              ) -> Optional[SiteInjection]:
    """The SiteInjection of one output block at step i from the device cache.
    Video UNet: temporal self-attention q/k in the direct layout [(b t), s,
    H*D]. Image UNet: spatial self-attention (attn1) and cross-attention
    (attn2) q/k. A site without cached entries is not injected (the reference
    skips absent feature files)."""
    def attn(site):
        names = [HarvestSpec.name(block, site, tensor) for tensor in ("q", "k")]
        q, k = (_cache_step(cache, n, i) if n in cache else None for n in names)
        return None if q is None and k is None else AttnInjection(gate=gate, q=q, k=k)

    if video:
        a1 = attn("temporal_self")
        return None if a1 is None else SiteInjection(temporal=BlockInjection(attn1=a1))
    a1, a2 = attn("spatial_self"), attn("spatial_cross")
    if a1 is None and a2 is None:
        return None
    return SiteInjection(spatial=BlockInjection(attn1=a1, attn2=a2))


def masks_to_latent(masks: torch.Tensor, latent_hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-resize per-frame masks [M, T, fh, fw] -> [M, T, h, w] for
    latent blending (sampling.py:239-249)."""
    return resize_nearest(masks, latent_hw)


@dataclasses.dataclass
class VidSegEngine:
    unet: UNetModel
    denoiser: Denoiser
    sampler: EulerEDMSampler
    guider: Union[LinearPredictionGuider, VanillaCFG]
    mod_cfg: ModulationConfig
    harvest: HarvestSpec = HarvestSpec()
    injected_sites: int = 0  # (block, step) sites that took cached q/k, over all runs

    def _denoise_fn(self, c: Cond, uc: Cond, hooks_fn=None, collect: bool = False):
        """denoise_fn(x, sigma, i) -> (guided denoised, harvested aux), with
        the CFG batch [uc; c] built by the guider."""
        t = self.mod_cfg.num_frames

        def denoise_fn(x, sigma: float, i: int):
            s = torch.full((x.shape[0],), sigma, dtype=x.dtype, device=x.device)
            x_in, s_in, cond = self.guider.prepare_inputs(x, s, c, uc)
            ioi = torch.zeros((x_in.shape[0] // t, t), dtype=x.dtype, device=x.device)
            hooks = hooks_fn(i) if hooks_fn is not None else UNetHooks()
            if collect:
                hooks.sow_blocks = self.harvest.blocks
                hooks.intermediates = {}

            def network(xs, c_noise, cond_d):
                if "concat" in cond_d:
                    xs = torch.cat([xs, cond_d["concat"].to(xs.dtype)], dim=-1)
                out = self.unet(
                    xs, c_noise, context=cond_d.get("crossattn"), y=cond_d.get("vector"),
                    num_video_frames=t, image_only_indicator=ioi, hooks=hooks,
                )
                return out, (self.harvest.extract(hooks.intermediates) if collect else {})

            denoised, aux = self.denoiser(network, x_in, s_in, cond)
            return self.guider(denoised, sigma), aux

        return denoise_fn

    @torch.no_grad()
    def invert(self, c: Cond, uc: Cond, latent: torch.Tensor) -> torch.Tensor:
        """Step-1 DDIM inversion (JAX engine/vidseg.py:496-506): the
        un-modulated CFG denoiser over the flipped sigma schedule, no harvest.
        Returns the noised latent in the sqrt(1 + sigma_0^2)-normalised frame
        add_noise produces, so the feature pass and the modulated runs take it
        unchanged."""
        x, _ = self.sampler.inversion(self._denoise_fn(c, uc), latent)
        return x

    @torch.no_grad()
    def xt_cache_pass(self, c: Cond, uc: Cond, noised: torch.Tensor, t_start: int):
        """Denoise steps t_start..num_steps-1 from the add_noise output,
        harvesting. Returns (x0, cache): cache maps harvest names -> [W, ...]
        and "xt" -> the post-step latents [W, T, h, w, z] with W = num_steps
        - t_start, windowed at cache["t0"] = t_start."""
        sampler = self.sampler
        sig = sampler.sigmas()
        x, sigmas = sampler.prescale(noised, sig), sig.tolist()
        denoise_fn = self._denoise_fn(c, uc, collect=True)
        steps: Dict[str, list] = {}
        for i in range(t_start, sampler.num_steps):
            x, aux = sampler.step(denoise_fn, x, sigmas[i], sigmas[i + 1], i)
            for name, arr in aux.items():
                steps.setdefault(name, []).append(arr)
            steps.setdefault("xt", []).append(x)
        cache: Dict = {}
        for name in list(steps):  # one entry at a time: the lists are freed as they are stacked
            cache[name] = torch.stack(steps.pop(name))
        cache["t0"] = t_start
        return x, cache

    def _build_hooks_fn(self, masks_tokens: torch.Tensor, lam: torch.Tensor,
                        cache: Optional[Dict] = None):
        """hooks_fn(i): the lambda * mask modulation of the modulated output
        blocks at step i (none on steps whose frame gate is all off: the
        JAX package adds exact zeros there) and, with is_injected_features
        and a cache, the cached q/k of the injected output blocks (none before the first modulated step: the JAX package's gate selects
        the computed q/k there)."""
        cfg = self.mod_cfg
        table = cfg.step_frame_table()
        video = self.unet.config.video

        def injection(i):
            if cache is None or not cfg.inject_gate_for_step(i):
                return {}
            on = torch.ones((), dtype=torch.bool, device=masks_tokens.device)
            sites = {b: _injection_site_for_block(b, cache, i, on, video) for b in cfg.output_block_indices}
            sites = {b: s for b, s in sites.items() if s is not None}
            self.injected_sites += len(sites)
            return sites

        def hooks_fn(i):
            gate = table[i]
            if not gate.any():
                return UNetHooks(output_inj=injection(i))
            frame_gate = torch.from_numpy(gate).to(masks_tokens.device)
            mod = Modulation(
                masks=masks_tokens, lam=lam.to(masks_tokens.device), frame_gate=frame_gate,
                enabled=frame_gate.any(),
            )
            block = BlockModulation(
                self_attn=mod if "self_attn" in cfg.modulate_attn_type else None,
                cross_attn=mod if "cross_attn" in cfg.modulate_attn_type else None,
                ff_out=mod if "ff_out" in cfg.modulate_attn_type else None,
            )
            site = SiteModulation(
                spatial=block if "spatial" in cfg.modulate_layer_type else None,
                temporal=block if video and "temporal" in cfg.modulate_layer_type else None,
            )
            return UNetHooks(output_mod={b: site for b in cfg.modulate_block_idx},
                             output_inj=injection(i))

        return hooks_fn

    @torch.no_grad()
    def modulated_runs(
        self,
        noised: torch.Tensor,
        c: Cond,
        uc: Cond,
        masks_tokens: torch.Tensor,   # [M, T, L] at the modulated block's resolution
        masks_latent: torch.Tensor,   # [M, T, h, w]
        cache: Dict,
        t_start: int,
        on_run_done: Optional[Callable[[int, torch.Tensor], None]] = None,
        process_group=None,
    ) -> torch.Tensor:
        """All 2*M (+/-lambda, mask) runs, runs outer: run r = sign * M + mask
        with +lambda first. Each run denoises steps t_start..num_steps-1 from
        the same noised latent; with latent blending, steps in the blend
        window pin the outside-mask cells to the cached trajectory. Returns
        final latents [2, M, T, h, w, z]; on_run_done(r, x) runs as soon as
        run r finishes (e.g. to decode it).

        Under a `process_group` (the JAX package's runs mesh) this rank runs
        only its share of the runs (parallel/runs.py: the masks k = rank mod
        the group's size, both signs) and calls on_run_done for those; every
        rank returns all the final latents, gathered in run order, and
        `injected_sites` counts the sites of every rank's runs."""
        cfg = self.mod_cfg
        sampler = self.sampler
        sig = sampler.sigmas()
        x0, sigmas = sampler.prescale(noised, sig), sig.tolist()
        b_start, b_end = cfg.blend_window()
        t0 = int(cache.get("t0", 0))
        m = masks_tokens.shape[0]
        runs = range(2 * m)
        if process_group is not None:
            runs = runs_of_rank(m, dist.get_rank(process_group), dist.get_world_size(process_group))
            sites_before = self.injected_sites
        finals = {}
        for r in runs:
            lam = cfg.lam() * (1.0 if r < m else -1.0)
            denoise_fn = self._denoise_fn(
                c, uc, hooks_fn=self._build_hooks_fn(masks_tokens[r % m], lam, cache))
            mlat = masks_latent[r % m][..., None].to(x0.dtype)
            x = x0
            for i in range(t_start, sampler.num_steps):
                x, _ = sampler.step(denoise_fn, x, sigmas[i], sigmas[i + 1], i)
                if cfg.is_latent_blending and b_start <= i <= b_end:
                    ori = cache["xt"][min(max(i - t0, 0), cache["xt"].shape[0] - 1)]
                    x = x * mlat + ori.to(x.dtype) * (1.0 - mlat)
            finals[r] = x
            if on_run_done is not None:
                on_run_done(r, x)
        if process_group is None:
            stacked = torch.stack([finals[r] for r in runs])
        else:
            stacked = all_gather_runs(finals, m, process_group)
            self.injected_sites = sites_before + all_reduce_sum(self.injected_sites - sites_before, process_group)
        return stacked.reshape((2, m) + x0.shape)
