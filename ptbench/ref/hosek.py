# Frozen copy of dxrpathtracer_tpu_torch/sky/hosek.py (data: a copy of its
# sky/data/hosek_data.npz) for the benchmark's reference.
"""Hosek-Wilkie sky + solar radiance model (numpy, host-side).

Implements the analytic models of Hosek & Wilkie ("An Analytic Model for Full
Spectral Sky-Dome Radiance", SIGGRAPH 2012; "Adding a Solar Radiance Function to
the Hosek Skylight Model", IEEE CG&A 2013) from the published coefficient
datasets (sky/data/hosek_data.npz, the port's copy of the JAX package's file,
extracted by tools/extract_hosek_data.py).
Fully vectorized over directions/wavelengths — the reference evaluates these
per-texel in scalar C++ (HosekSky/ArHosekSkyModel.cpp); here one numpy pass
builds the whole cubemap. A copy of dxrpathtracer_tpu/sky/hosek.py without
its fallback model: a missing dataset raises.

Behavioral parity notes vs the reference's SkyCache usage (Graphics/Skybox.cpp):
  - RGB sky states are cooked at `elevation = pi/2 - thetaS` (Skybox.cpp:69-72).
  - The *spectral* states used for the solar-disc integral are cooked with
    `thetaS` passed as the elevation argument (Skybox.cpp:90-91 passes the
    zenith angle into alloc_init's solar_elevation parameter) — a reference
    quirk reproduced here so SunIrradiance matches.
  - Ground albedo RGB -> spectrum uses the PBRT/Smits reflectance basis;
    spectrum -> RGB uses the CIE 2-degree observer resampled to 60 bins over
    400-700nm (Graphics/Spectrum.{h,cpp}).
  - Sky radiance below the horizon is clamped to the horizon value (the
    reference evaluates sqrt(cos theta) < 0 -> NaN texels; we avoid the NaNs).
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np

# The coefficient dataset, the port's own copy (byte-equal to the JAX
# package's, held so by tests/test_torch_history.py).
_DATA_PATH = Path(__file__).resolve().parent / "data" / "hosek_data.npz"

TERRESTRIAL_SOLAR_RADIUS = np.deg2rad(0.51) / 2.0
_SOLAR_PIECES = 45
_SOLAR_ORDER = 4

# SampledSpectrum constants (Graphics/Spectrum.h:43-45,76)
SAMPLED_LAMBDA_START = 400.0
SAMPLED_LAMBDA_END = 700.0
NUM_SPECTRAL_SAMPLES = 60
CIE_Y_INTEGRAL = 106.856895


@functools.lru_cache(maxsize=1)
def _data():
    return dict(np.load(_DATA_PATH))


def have_dataset() -> bool:
    return _DATA_PATH.exists()


# ---------------------------------------------------------------------------
# Spectrum utilities (PBRT-style piecewise-linear resampling)
# ---------------------------------------------------------------------------

def average_spectrum_samples(lam, vals, l0, l1):
    """Average of the piecewise-linear spectrum (lam, vals) over [l0, l1]."""
    n = len(lam)
    if l1 <= lam[0]:
        return float(vals[0])
    if l0 >= lam[-1]:
        return float(vals[-1])
    if n == 1:
        return float(vals[0])
    total = 0.0
    if l0 < lam[0]:
        total += vals[0] * (lam[0] - l0)
    if l1 > lam[-1]:
        total += vals[-1] * (l1 - lam[-1])
    i = 0
    while l0 > lam[i + 1]:
        i += 1

    def interp(w, i):
        t = (w - lam[i]) / (lam[i + 1] - lam[i])
        return vals[i] * (1 - t) + vals[i + 1] * t

    while i + 1 < n and l1 >= lam[i]:
        s = max(l0, lam[i])
        e = min(l1, lam[i + 1])
        if e > s:
            total += 0.5 * (interp(s, i) + interp(e, i)) * (e - s)
        i += 1
    return float(total / (l1 - l0))


@functools.lru_cache(maxsize=1)
def _resampled_tables():
    """CIE X/Y/Z and Smits reflectance bases resampled to the 60 render bins."""
    d = _data()
    bins = np.zeros((NUM_SPECTRAL_SAMPLES, 2))
    for i in range(NUM_SPECTRAL_SAMPLES):
        bins[i, 0] = SAMPLED_LAMBDA_START + (SAMPLED_LAMBDA_END - SAMPLED_LAMBDA_START) * i / NUM_SPECTRAL_SAMPLES
        bins[i, 1] = SAMPLED_LAMBDA_START + (SAMPLED_LAMBDA_END - SAMPLED_LAMBDA_START) * (i + 1) / NUM_SPECTRAL_SAMPLES

    def resample(lam, vals):
        return np.array([average_spectrum_samples(lam, vals, b0, b1) for b0, b1 in bins])

    cie_lam = d["CIE_lambda"]
    tables = {
        "X": resample(cie_lam, d["CIE_X"]),
        "Y": resample(cie_lam, d["CIE_Y"]),
        "Z": resample(cie_lam, d["CIE_Z"]),
    }
    s_lam = d["RGB2SpectLambda"]
    for k in ["White", "Cyan", "Magenta", "Yellow", "Red", "Green", "Blue"]:
        tables[f"refl_{k.lower()}"] = resample(s_lam, d[f"RGBRefl2Spect{k}"])
    return tables


def rgb_to_reflectance_spectrum(rgb):
    """SampledSpectrum::FromRGB, SpectrumType::Reflectance (Spectrum.cpp:113+)."""
    t = _resampled_tables()
    r, g, b = float(rgb[0]), float(rgb[1]), float(rgb[2])
    out = np.zeros(NUM_SPECTRAL_SAMPLES)
    w, c, m, y = t["refl_white"], t["refl_cyan"], t["refl_magenta"], t["refl_yellow"]
    rr, gg, bb = t["refl_red"], t["refl_green"], t["refl_blue"]
    if r <= g and r <= b:
        out += r * w
        if g <= b:
            out += (g - r) * c
            out += (b - g) * bb
        else:
            out += (b - r) * c
            out += (g - b) * gg
    elif g <= r and g <= b:
        out += g * w
        if r <= b:
            out += (r - g) * m
            out += (b - r) * bb
        else:
            out += (b - g) * m
            out += (r - b) * rr
    else:
        out += b * w
        if r <= g:
            out += (r - b) * y
            out += (g - r) * gg
        else:
            out += (g - b) * y
            out += (r - g) * rr
    out *= 0.94
    return np.clip(out, 0.0, None)


def spectrum_to_rgb(spec):
    """SampledSpectrum::ToRGB (Spectrum.h:361-384): (..., 60) -> (..., 3)."""
    t = _resampled_tables()
    scale = (SAMPLED_LAMBDA_END - SAMPLED_LAMBDA_START) / (CIE_Y_INTEGRAL * NUM_SPECTRAL_SAMPLES)
    x = spec @ t["X"] * scale
    y = spec @ t["Y"] * scale
    z = spec @ t["Z"] * scale
    r = 3.240479 * x - 1.537150 * y - 0.498535 * z
    g = -0.969256 * x + 1.875991 * y + 0.041556 * z
    b = 0.055648 * x - 0.204043 * y + 1.057311 * z
    return np.stack([r, g, b], axis=-1)


# ---------------------------------------------------------------------------
# Model cooking (quintic Bezier over elevation^(1/3), bilinear turbidity/albedo)
# ---------------------------------------------------------------------------

def _bezier5(ctrl, t):
    """Quintic Bezier: ctrl (..., 6, K), t scalar -> (..., K)."""
    s = 1.0 - t
    w = np.array([s**5, 5 * s**4 * t, 10 * s**3 * t**2,
                  10 * s**2 * t**3, 5 * s * t**4, t**5])
    return np.tensordot(w, ctrl, axes=(0, -2)) if ctrl.ndim == 2 else np.einsum(
        "k,...kc->...c", w, ctrl)


def cook_configuration(dataset, turbidity, albedo, solar_elevation):
    """ArHosekSkyModel_CookConfiguration: dataset (2, 10, 6, K) -> (..., K).

    albedo may be scalar or (A,) (vectorized over spectral albedo values).
    """
    turbidity = float(np.clip(turbidity, 1.0, 10.0))
    int_turb = min(int(turbidity), 10)
    turb_rem = turbidity - int_turb
    t = (solar_elevation / (np.pi / 2.0)) ** (1.0 / 3.0)

    albedo = np.asarray(albedo, np.float64)
    a = albedo[..., None]  # broadcast over K

    lo0 = _bezier5(dataset[0, int_turb - 1], t)   # albedo 0, low turb
    lo1 = _bezier5(dataset[1, int_turb - 1], t)   # albedo 1, low turb
    cfg = (1.0 - a) * (1.0 - turb_rem) * lo0 + a * (1.0 - turb_rem) * lo1
    if int_turb < 10:
        hi0 = _bezier5(dataset[0, int_turb], t)
        hi1 = _bezier5(dataset[1, int_turb], t)
        cfg = cfg + (1.0 - a) * turb_rem * hi0 + a * turb_rem * hi1
    return cfg


def get_radiance_internal(config, theta, gamma):
    """ArHosekSkyModel_GetRadianceInternal, vectorized.

    config: (..., 9) broadcastable against theta/gamma (...,).
    """
    cos_g = np.cos(gamma)
    cos_t = np.clip(np.cos(theta), 0.0, 1.0)  # horizon clamp (see module doc)
    exp_m = np.exp(config[..., 4] * gamma)
    ray_m = cos_g * cos_g
    mie_m = (1.0 + cos_g * cos_g) / np.power(
        1.0 + config[..., 8] ** 2 - 2.0 * config[..., 8] * cos_g, 1.5)
    zenith = np.sqrt(cos_t)
    return ((1.0 + config[..., 0] * np.exp(config[..., 1] / (cos_t + 0.01)))
            * (config[..., 2] + config[..., 3] * exp_m + config[..., 5] * ray_m
               + config[..., 6] * mie_m + config[..., 7] * zenith))


# ---------------------------------------------------------------------------
# Solar direct radiance (2013 model)
# ---------------------------------------------------------------------------

def _solar_direct(solar_ds, turbidity, elevation, wl_low, wl_frac):
    """arhosekskymodel_solar_radiance_internal2's direct term, vectorized over
    elevation (...,). solar_ds: (11, 10, 45, 4)."""
    turb_low = int(turbidity) - 1
    turb_frac = turbidity - (turb_low + 1)
    if turb_low == 9:
        turb_low = 8
        turb_frac = 1.0

    elevation = np.asarray(elevation, np.float64)
    pos = ((2.0 * np.maximum(elevation, 0.0) / np.pi) ** (1.0 / 3.0) * _SOLAR_PIECES).astype(np.int64)
    pos = np.minimum(pos, _SOLAR_PIECES - 1)
    break_x = (pos / _SOLAR_PIECES) ** 3.0 * (np.pi * 0.5)
    x = elevation - break_x

    def sr(turb, wl):
        coefs = solar_ds[wl, turb, pos]  # (..., 4) highest order last
        # res = sum_i x^i * coefs[order-1-i] (the C code walks backwards)
        res = np.zeros_like(x)
        x_exp = np.ones_like(x)
        for i in range(_SOLAR_ORDER):
            res = res + x_exp * coefs[..., _SOLAR_ORDER - 1 - i]
            x_exp = x_exp * x
        return res

    def wl_interp(turb):
        lo = sr(turb, wl_low)
        if wl_frac == 0.0 or wl_low + 1 >= 11:
            return lo
        return (1.0 - wl_frac) * lo + wl_frac * sr(turb, wl_low + 1)

    direct = (1.0 - turb_frac) * wl_interp(turb_low)
    if turb_frac != 0.0:
        direct = direct + turb_frac * wl_interp(turb_low + 1)
    return direct


# ---------------------------------------------------------------------------
# Public model objects
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HosekSkyModel:
    """RGB sky radiance + spectral solar radiance for one sun configuration."""

    sun_direction: np.ndarray
    turbidity: float
    ground_albedo: np.ndarray
    name: str = "hosek"

    def __post_init__(self):
        d = _data()
        up = np.array([0.0, 1.0, 0.0])
        cos_theta_s = float(np.clip(np.dot(self.sun_direction, up), -1.0, 1.0))
        self.theta_s = float(np.arccos(cos_theta_s))
        self.elevation = np.pi / 2.0 - self.theta_s
        turb = float(np.clip(self.turbidity, 1.0, 10.0))

        # RGB states (Skybox.cpp:69-72): per-channel albedo
        self._rgb_config = np.stack([
            cook_configuration(d["rgb_config"][c], turb,
                               float(self.ground_albedo[c]), self.elevation)
            for c in range(3)])  # (3, 9)
        self._rgb_rad = np.array([
            cook_configuration(d["rgb_radiance"][c][..., None], turb,
                               float(self.ground_albedo[c]), self.elevation)[0]
            for c in range(3)])  # (3,)

        # Spectral states for the solar integral (Skybox.cpp:88-91): cooked with
        # thetaS passed as elevation (reference quirk, see module docstring).
        albedo_spec = rgb_to_reflectance_spectrum(self.ground_albedo)  # (60,)
        self._albedo_spec = albedo_spec
        spec_cfg = d["spectral_config"]       # (11, 2, 10, 6, 9)
        spec_rad = d["spectral_radiance"]     # (11, 2, 10, 6)
        self._spec_config = np.stack([
            cook_configuration(spec_cfg[wl], turb, albedo_spec, self.theta_s)
            for wl in range(11)])  # (11, 60, 9)
        self._spec_rad = np.stack([
            cook_configuration(spec_rad[wl][..., None], turb, albedo_spec, self.theta_s)[..., 0]
            for wl in range(11)])  # (11, 60)
        self._solar_ds = d["solar"]
        self._limb = d["limb_darkening"]
        self._turb = turb

    # -- RGB sky dome (SkyCache::Sample, Skybox.cpp:252-270, without the 683
    #    luminous-efficacy factor which the caller applies) --
    def sky_radiance(self, dirs):
        dirs = np.asarray(dirs, np.float64)
        cos_t = np.clip(dirs[..., 1], -1.0, 1.0)
        theta = np.arccos(cos_t)
        cos_g = np.clip(dirs @ self.sun_direction.astype(np.float64), -1.0, 1.0)
        gamma = np.arccos(cos_g)
        out = np.stack([
            get_radiance_internal(self._rgb_config[c], theta, gamma) * self._rgb_rad[c]
            for c in range(3)], axis=-1)
        return np.clip(out, 0.0, None).astype(np.float32)

    # -- spectral sky radiance at the 60 render wavelengths: (..., 60) --
    def _sky_radiance_spectral(self, theta, gamma):
        lam = SAMPLED_LAMBDA_START + (SAMPLED_LAMBDA_END - SAMPLED_LAMBDA_START) * (
            np.arange(NUM_SPECTRAL_SAMPLES) / NUM_SPECTRAL_SAMPLES)
        out = np.zeros(theta.shape + (NUM_SPECTRAL_SAMPLES,))
        for i, wavelength in enumerate(lam):
            low = int((wavelength - 320.0) / 40.0)
            frac = ((wavelength - 320.0) / 40.0) % 1.0
            val_low = (get_radiance_internal(self._spec_config[low, i], theta, gamma)
                       * self._spec_rad[low, i])
            if frac < 1e-6:
                out[..., i] = val_low
                continue
            res = (1.0 - frac) * val_low
            if low + 1 < 11:
                res = res + frac * (get_radiance_internal(self._spec_config[low + 1, i],
                                                          theta, gamma)
                                    * self._spec_rad[low + 1, i])
            out[..., i] = res
        return out

    # -- solar radiance (direct + inscattered) -> RGB (arhosekskymodel_solar_
    #    radiance + SampledSpectrum::ToRGB as used by Skybox.cpp:104-127) --
    def solar_radiance(self, dirs):
        dirs = np.asarray(dirs, np.float64)
        cos_t = np.clip(dirs[..., 1], -1.0, 1.0)
        theta = np.arccos(cos_t)
        elevation = np.pi / 2.0 - theta
        cos_g = np.clip(dirs @ self.sun_direction.astype(np.float64), -1.0, 1.0)
        gamma = np.arccos(cos_g)

        lam = SAMPLED_LAMBDA_START + (SAMPLED_LAMBDA_END - SAMPLED_LAMBDA_START) * (
            np.arange(NUM_SPECTRAL_SAMPLES) / NUM_SPECTRAL_SAMPLES)
        spec = np.zeros(theta.shape + (NUM_SPECTRAL_SAMPLES,))
        sol_rad_sin = np.sin(TERRESTRIAL_SOLAR_RADIUS)
        ar2 = 1.0 / (sol_rad_sin * sol_rad_sin)
        sin_g = np.sin(gamma)
        sample_cosine = np.sqrt(np.maximum(1.0 - ar2 * sin_g * sin_g, 0.0))
        for i, wavelength in enumerate(lam):
            wl_low = int((wavelength - 320.0) / 40.0)
            wl_frac = (wavelength % 40.0) / 40.0
            if wl_low == 10:
                wl_low = 9
                wl_frac = 1.0
            direct = _solar_direct(self._solar_ds, self._turb, elevation, wl_low, wl_frac)
            ld = (1.0 - wl_frac) * self._limb[wl_low] + wl_frac * self._limb[min(wl_low + 1, 10)]
            darkening = (ld[0] + ld[1] * sample_cosine + ld[2] * sample_cosine**2
                         + ld[3] * sample_cosine**3 + ld[4] * sample_cosine**4
                         + ld[5] * sample_cosine**5)
            spec[..., i] = direct * darkening
        spec += self._sky_radiance_spectral(theta, gamma)
        return np.clip(spectrum_to_rgb(spec), 0.0, None).astype(np.float32)


def make_sky_model(sun_direction, turbidity, ground_albedo):
    if not have_dataset():
        raise FileNotFoundError(f"Hosek-Wilkie coefficients missing: {_DATA_PATH}")
    sun_direction = np.asarray(sun_direction, np.float64)
    ground_albedo = np.asarray(ground_albedo, np.float64)
    return HosekSkyModel(sun_direction, float(turbidity), ground_albedo)
