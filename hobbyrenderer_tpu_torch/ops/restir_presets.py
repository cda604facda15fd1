"""ReSTIR quality presets + checkerboard mode — the runtime perf/quality
levers of the reference's RTXDI integration.

Reference: src/RTXDIRenderer.cpp:96-247 (ApplyHighPerfPreset /
ApplyBalancedPreset / ApplyHighQualityPreset) and rtxdi::CheckerboardMode.
The reference presets move: initial candidate counts (4/8/16), spatial tap
counts (1/1/4), boiling filter on/off, temporal history/reservoir-age caps
and bias-correction modes. This port maps each onto the equivalent knob of
ops/restir.py / ops/restir_gi.py:

- di_candidates      <- numLocalLightSamples (4 / 8 / 16)
- di_spatial_taps    <- spatial numSamples (+disocclusion boost folded in)
- di_boiling_mult    <- enableBoilingFilter/strength (0 disables; NRD-era
                        high-quality preset turns it off and lets the
                        denoiser eat the noise)
- di_checkerboard    <- CheckerboardMode: candidate generation runs on a
                        frame-alternating half grid (ops/restir.py gathers
                        even/odd columns per row — a strided select, no
                        gathers); temporal reuse carries the off-parity
                        pixels, exactly the reference's reconstruction story.
- gi_spatial_taps    <- GI spatial numSamples
- gi_m_clamp         <- maxHistoryLength (temporal M cap)
- gi_half_rate       <- GI ray budget (frame-alternating trace), the analogue
                        of the reference running GI at reduced rate in the
                        perf presets
"""

from __future__ import annotations

from typing import NamedTuple


class ReSTIRPreset(NamedTuple):
    name: str = "balanced"
    di_candidates: int = 8
    # 2 taps: golden-neutral vs 3 (measured RMSE 0.1156 vs 0.1155 at 96x64;
    # the ref balanced preset runs 1 spatial pass + boost)
    di_spatial_taps: int = 2
    di_boiling_mult: float = 20.0
    di_checkerboard: bool = False
    gi_spatial_taps: int = 4
    gi_m_clamp: float = 12.0
    gi_half_rate: bool = True
    # traced-specular ray budget: checkerboard half-rate (the same
    # CheckerboardMode lever applied to the BrdfRayTracing pass)
    spec_half_rate: bool = True
    # winner-visibility ray budget: trace the (::N, ::N) subgrid; same-winner
    # lanes reuse the bit, mismatched lanes re-trace exactly (ops/restir.py
    # vis_scale — the reduced-rate analogue of the ref perf presets' ray cuts)
    di_vis_scale: int = 2


PRESETS = {
    # ref ApplyHighPerfPreset: 4 samples, 1 spatial tap, aggressive reuse
    "highperf": ReSTIRPreset(name="highperf", di_candidates=4,
                             di_spatial_taps=1, di_boiling_mult=20.0,
                             di_checkerboard=True, gi_spatial_taps=2,
                             gi_m_clamp=6.0, gi_half_rate=True),
    # ref ApplyBalancedPreset: 8 samples, 1+boost spatial, boiling on
    "balanced": ReSTIRPreset(),
    # ref ApplyHighQualityPreset: 16 samples, 4 spatial taps, boiling OFF
    # (the denoiser owns the noise), long GI history, full-rate GI
    "highquality": ReSTIRPreset(name="highquality", di_candidates=16,
                                di_spatial_taps=5, di_boiling_mult=0.0,
                                di_checkerboard=False, gi_spatial_taps=5,
                                gi_m_clamp=20.0, gi_half_rate=False,
                                spec_half_rate=False, di_vis_scale=1),
}


def get_preset(name: str) -> ReSTIRPreset:
    try:
        return PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown ReSTIR quality preset '{name}' "
                         f"(one of {sorted(PRESETS)})") from None
