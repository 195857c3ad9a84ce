"""Time and energy accounting — paper §III-A/III-B, equations (4)-(7)
(copy of ``repro.core.energy``; every field must match it to the float).

    T_train = T_dev + T_hand + T_key + T_init + T_com
            + T_enc + T_dec + T_agg + T_loc                      (4)
    E_tot   = E_comp + E_comm                                     (5)
    E_comp  = T_init*E_ci + (T_enc+T_dec)*E_c + T_agg*E_ca + T_loc*E_cl   (6)
    E_comm  = (T_dev+T_hand)*E_s + (T_hand+T_key+T_com)*E_r       (7)

The device profile defaults approximate the paper's simulation setting
("mobile device with an average power consumption of 5 watts per unit
time") with per-mode powers; the link profile approximates OFDMA WiFi.
``measured_local_time`` lets the fleet simulator substitute the actual
wall-clock of local fitting for the analytic T_loc term (semi-empirical
mode, matching how the paper measures on VMs).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.kernels.quantize.ops import compressed_nbytes, resolve_compress


def update_wire_bytes(num_params: int, *, encrypt: bool = True,
                      compress: Optional[str] = None,
                      raw_bytes: Optional[int] = None) -> int:
    """Bytes ONE model update occupies on the wire — the ``model_bytes``
    every eq. (4)-(7) term is priced from.

    Under ``compress="int8"`` the update is a tile-padded int8 payload
    plus one fp32 scale per tile
    (``repro_torch.kernels.quantize.ops.compressed_nbytes``), the same
    count encrypted or not; ``"auto"`` resolves through the engines' own
    ``resolve_compress`` first.  An encrypted fp32 update is the
    serialized stream (``4 * num_params``); a plaintext one is the raw
    tree bytes when the caller supplies them.
    """
    compress = resolve_compress(compress, num_params)
    if compress == "int8":
        return compressed_nbytes(num_params)
    if encrypt or raw_bytes is None:
        return 4 * num_params
    return raw_bytes


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Per-mode average power draw (W) and compute throughput."""

    name: str = "mobile-5w"
    p_tx: float = 1.6            # E_s: transmit mode
    p_rx: float = 1.2            # E_r: receive mode
    p_init: float = 0.8          # E_ci: model initialization
    p_crypto: float = 1.0        # E_c: AES encrypt/decrypt
    p_agg: float = 1.5           # E_ca: aggregation
    p_train: float = 5.0         # E_cl: local training (paper: 5 W average)
    p_idle: float = 0.05         # low-power listen draw while waiting out
                                 # cadence idle / duty-cycle-off windows
    flops: float = 8e9           # sustained training FLOP/s of the device
    crypto_bytes_per_s: float = 80e6   # AES-128 throughput
    agg_params_per_s: float = 400e6    # aggregation throughput (params/s)
    battery_capacity_j: float = 40e3   # ~ 3000 mAh @ 3.7 V


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    name: str = "ofdma-wifi"
    rate_bps: float = 40e6       # rho: data transmission rate
    request_bytes: int = 256     # beta: size of the request message
    key_bytes: int = 16          # AES-128 key
    handshake_s: float = 0.02    # per-contributor handshake latency
    # cloud path (for the cloud-only baseline): WAN uplink + server queue
    wan_rate_bps: float = 12e6
    cloud_rtt_s: float = 0.12


@dataclasses.dataclass
class PhaseTimes:
    """All terms of eq. (4), in seconds."""

    t_dev: float = 0.0
    t_hand: float = 0.0
    t_key: float = 0.0
    t_init: float = 0.0
    t_com: float = 0.0
    t_enc: float = 0.0
    t_dec: float = 0.0
    t_agg: float = 0.0
    t_loc: float = 0.0

    @property
    def total(self) -> float:
        return (self.t_dev + self.t_hand + self.t_key + self.t_init + self.t_com
                + self.t_enc + self.t_dec + self.t_agg + self.t_loc)


@dataclasses.dataclass
class EnergyReport:
    times: PhaseTimes
    e_comp: float
    e_comm: float

    @property
    def e_tot(self) -> float:
        return self.e_comp + self.e_comm

    @property
    def t_train(self) -> float:
        return self.times.total


class CostModel:
    """Accumulates eq. (4)-(7) terms for one device over an FL session."""

    def __init__(self, device: DeviceProfile = DeviceProfile(),
                 link: LinkProfile = LinkProfile(),
                 parallel_receive: bool = True):
        self.device = device
        self.link = link
        self.parallel_receive = parallel_receive

    # --- individual phase timings -----------------------------------------
    def t_request(self, n_devices: int) -> float:
        # broadcast request: beta/rho (paper: O(beta/rho) time)
        return 8.0 * self.link.request_bytes / self.link.rate_bps

    def t_handshake(self, n_contrib: int) -> float:
        return n_contrib * self.link.handshake_s

    def t_key_exchange(self, n_contrib: int) -> float:
        if n_contrib <= 0:
            return 0.0   # nobody to exchange keys with (empty neighborhood)
        per = 8.0 * self.link.key_bytes / self.link.rate_bps
        return per if self.parallel_receive else n_contrib * per

    def t_receive_updates(self, n_contrib: int, model_bytes: int) -> float:
        if n_contrib <= 0:
            return 0.0   # member-less round: nothing arrives on the wire
        per = 8.0 * model_bytes / self.link.rate_bps
        return per if self.parallel_receive else n_contrib * per

    def t_crypto(self, model_bytes: int) -> float:
        return model_bytes / self.device.crypto_bytes_per_s

    def t_aggregate(self, n_contrib: int, num_params: int) -> float:
        return n_contrib * num_params / self.device.agg_params_per_s

    def t_local_fit(self, num_params: int, num_samples: int, epochs: int) -> float:
        # fwd+bwd ~ 6 FLOPs per param per sample
        return 6.0 * num_params * num_samples * epochs / self.device.flops

    # --- full-session roll-up ----------------------------------------------
    def session(self, *, rounds: int, n_contrib: int, num_params: int,
                model_bytes: int, num_samples: int, epochs: int,
                n_devices: Optional[int] = None,
                measured_local_time: Optional[float] = None,
                encrypt: bool = True) -> EnergyReport:
        """EnFed session cost for the requesting device (Algorithm 1)."""
        n_devices = n_devices if n_devices is not None else n_contrib
        t = PhaseTimes()
        t.t_dev = self.t_request(n_devices)
        t.t_hand = self.t_handshake(n_contrib)
        t.t_key = self.t_key_exchange(n_contrib)
        t.t_init = 1e-3  # O(1)
        t.t_com = rounds * self.t_receive_updates(n_contrib, model_bytes)
        if encrypt:
            # requester decrypts every received update; its own outbound
            # traffic is requests only, so t_enc covers the (small) ack path
            t.t_dec = rounds * n_contrib * self.t_crypto(model_bytes)
            t.t_enc = rounds * self.t_crypto(self.link.request_bytes)
        t.t_agg = rounds * self.t_aggregate(n_contrib, num_params)
        t.t_loc = (measured_local_time if measured_local_time is not None
                   else rounds * self.t_local_fit(num_params, num_samples, epochs))
        return self._energy(t)

    def round_energy(self, *, n_contrib: int, num_params: int, model_bytes: int,
                     num_samples: int, epochs: int,
                     n_devices: Optional[int] = None,
                     encrypt: bool = True) -> float:
        """E_tot of one EnFed round (eq. 5 with ``rounds=1``).

        This is the per-round battery-discharge constant: given a fixed
        model/contributor population it does not depend on traced state,
        so the fleet engine precomputes it host-side per requester and
        the loop engine charges it after every executed round.  Both
        engines MUST use this method so battery trajectories match.
        """
        return self.session(rounds=1, n_contrib=n_contrib, num_params=num_params,
                            model_bytes=model_bytes, num_samples=num_samples,
                            epochs=epochs, n_devices=n_devices,
                            encrypt=encrypt).e_tot

    def screening_energy(self, *, n_contrib: int, num_params: int):
        """Cost of ONE round's Byzantine-robust screening pass, split as
        ``(e_screen, t_screen_s)``: one more pass over the ``n_contrib x
        num_params`` delivered buffer at the aggregation throughput and
        power.  Both engines add it post hoc to the report's ``t_agg`` and
        ``e_comp`` per executed round; it never drains the simulated
        battery, so a defended and an undefended run of one world keep
        equal battery traces."""
        t_screen = self.t_aggregate(n_contrib, num_params)
        return t_screen * self.device.p_agg, t_screen

    def _energy(self, t: PhaseTimes) -> EnergyReport:
        d = self.device
        e_comp = (t.t_init * d.p_init + (t.t_enc + t.t_dec) * d.p_crypto
                  + t.t_agg * d.p_agg + t.t_loc * d.p_train)
        e_comm = (t.t_dev + t.t_hand) * d.p_tx + (t.t_hand + t.t_key + t.t_com) * d.p_rx
        return EnergyReport(times=t, e_comp=e_comp, e_comm=e_comm)
