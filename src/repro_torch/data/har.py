"""Synthetic stand-ins for the paper's two HAR datasets (a numpy copy of
``repro.data.har``; it must produce the same arrays).

The paper uses two Kaggle datasets that are not available offline:

* **Dataset 1** — "Calories burned during exercise and activities":
  tabular features -> calorie-range class in {<0.5, 0.5-1, 1-2, 2-3, >3}
  (5 classes), analysed with the MLP.
* **Dataset 2** — "HARSense": accelerometer + gyroscope streams of 12
  users -> activity in {Running, Walking, Sitting, Standing, Downstairs,
  Upstairs} (6 classes), analysed with the LSTM.

We synthesize both with class-conditional generative signatures chosen so
that (a) the task is learnable to the paper's reported >95% accuracy
bracket with the paper's models, (b) classes overlap enough to be
non-trivial, and (c) per-user style factors exist so a Dirichlet non-IID
split produces genuinely heterogeneous clients (the paper distributes
both datasets non-identically across the requester + 5 supporters).
"""

from __future__ import annotations

import dataclasses

import numpy as np

HAR_ACTIVITIES = ("Running", "Walking", "Sitting", "Standing", "Downstairs", "Upstairs")
CALORIE_CLASSES = ("<0.5", "0.5-1", "1-2", "2-3", ">3")


@dataclasses.dataclass(frozen=True)
class HARDatasetConfig:
    num_samples: int = 6000
    seq_len: int = 64
    num_channels: int = 6       # 3-axis accelerometer + 3-axis gyroscope
    num_users: int = 12         # HARSense has 12 users
    noise: float = 0.35
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class CaloriesDatasetConfig:
    num_samples: int = 5000
    num_features: int = 8       # activity intensity, duration, weight, ...
    noise: float = 0.10         # sensor noise on physiology features
    cal_noise: float = 0.04     # wearable calorie-rate estimate noise
    seed: int = 0


# per-activity signature: (base freq, amplitude, gravity-axis offset, harmonic amp)
_ACT_SIG = {
    0: (2.6, 2.0, 0.4, 0.8),   # Running: high freq, high amp
    1: (1.4, 1.0, 0.4, 0.4),   # Walking
    2: (0.05, 0.05, -0.9, 0.0),  # Sitting: near-static, tilted gravity
    3: (0.05, 0.05, 1.0, 0.0),   # Standing: near-static, upright gravity
    4: (1.7, 1.3, 0.1, 0.6),   # Downstairs: walking-like + impact harmonic
    5: (1.2, 1.5, 0.7, 0.3),   # Upstairs: slower, high vertical effort
}


def make_har_windows(cfg: HARDatasetConfig = HARDatasetConfig()):
    """Returns (x, y, user): x (N, T, C) fp32, y (N,) int32, user (N,) int32."""
    rng = np.random.default_rng(cfg.seed)
    N, T, C = cfg.num_samples, cfg.seq_len, cfg.num_channels
    y = rng.integers(0, len(HAR_ACTIVITIES), size=N)
    user = rng.integers(0, cfg.num_users, size=N)
    # per-user style: gain and frequency scaling (body mass / gait differences)
    user_gain = rng.normal(1.0, 0.12, size=cfg.num_users)
    user_freq = rng.normal(1.0, 0.08, size=cfg.num_users)
    t = np.arange(T)[None, :, None] / 20.0  # 20 Hz sampling
    phase = rng.uniform(0, 2 * np.pi, size=(N, 1, C))
    chan_mix = rng.normal(1.0, 0.2, size=(1, 1, C))

    freq = np.array([_ACT_SIG[c][0] for c in y])[:, None, None]
    amp = np.array([_ACT_SIG[c][1] for c in y])[:, None, None]
    grav = np.array([_ACT_SIG[c][2] for c in y])[:, None, None]
    harm = np.array([_ACT_SIG[c][3] for c in y])[:, None, None]

    freq = freq * user_freq[user][:, None, None]
    amp = amp * user_gain[user][:, None, None]

    x = amp * np.sin(2 * np.pi * freq * t + phase) * chan_mix
    x = x + harm * np.sin(2 * np.pi * 2 * freq * t + 2 * phase)
    # gravity offset on the "vertical" channels (first of each sensor triple)
    x[:, :, 0::3] += grav
    x = x + rng.normal(0, cfg.noise, size=x.shape)
    return x.astype(np.float32), y.astype(np.int32), user.astype(np.int32)


def make_calories_tabular(cfg: CaloriesDatasetConfig = CaloriesDatasetConfig()):
    """Returns (x, y): x (N, F) fp32, y (N,) int32 calorie-range class.

    kcal/min = MET x 3.5 x kg / 200 (the standard MET formula); classes
    are the paper's calorie-rate bins (<0.5, 0.5-1, 1-2, 2-3, >3).  The
    feature set mimics the Kaggle table: noisy physiology readings plus a
    wearable's own (noisy) calorie-rate estimate; with the default noise
    the achievable accuracy sits in the paper's ~96% band for the MLP.
    """
    rng = np.random.default_rng(cfg.seed)
    N, F = cfg.num_samples, cfg.num_features
    # latent physiology: intensity (MET-like), duration, body weight
    intensity = rng.gamma(2.0, 0.8, size=N)           # ~ MET score
    duration = rng.uniform(0.2, 1.5, size=N)          # hours
    weight = rng.normal(75, 12, size=N)               # kg
    cal_per_min = intensity * weight * 3.5 / 200.0    # kcal/min MET formula
    bins = np.array([0.5, 1.0, 2.0, 3.0])
    y = np.digitize(cal_per_min, bins)

    x = np.zeros((N, F), np.float32)
    x[:, 0] = intensity + rng.normal(0, cfg.noise, N)
    x[:, 1] = duration + rng.normal(0, cfg.noise * 0.3, N)
    x[:, 2] = (weight - 75) / 12 + rng.normal(0, cfg.noise, N)
    x[:, 3] = intensity * duration + rng.normal(0, cfg.noise * 2, N)   # effort volume
    x[:, 4] = np.log1p(intensity) + rng.normal(0, cfg.noise, N)
    x[:, 5] = rng.normal(0, 1, N)                                      # nuisance
    x[:, 6] = cal_per_min + rng.normal(0, cfg.cal_noise, N)            # wearable estimate
    x[:, 7] = rng.normal(25, 4, N) / 10                                # BMI-ish nuisance
    return x.astype(np.float32), y.astype(np.int32)
