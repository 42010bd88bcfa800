"""The port's mock-GPS encoders against the JAX package's: the NMEA
sentence block, the UBX NAV-PVT dict and its framed bytes, and the uORB
SensorGps dict must be equal (byte for byte, field for field) on seeded
fixes."""
import numpy as np
import pytest

from gisnav_tpu.io import nmea as jax_nmea
from gisnav_tpu.io import ubx as jax_ubx
from gisnav_tpu.io import uorb as jax_uorb
from gisnav_tpu_torch.io import nmea, ubx, uorb


def _fix(seed):
    """A mock-GPS fix dict as ``MockGPSNode.odom_to_fix`` builds one."""
    rng = np.random.default_rng(seed)
    lat = float(rng.uniform(-80, 80))
    lon = float(rng.uniform(-179, 179))
    alt = float(rng.uniform(-50, 3000))
    return {
        "lat": int(lat * 1e7), "lon": int(lon * 1e7),
        "altitude_ellipsoid": alt,
        "altitude_amsl": alt - float(rng.uniform(-100, 80)),
        "yaw_degrees": int(rng.integers(1, 361)),
        "h_variance_rad": float(rng.uniform(0, 0.1)),
        "vel_n_m_s": float(rng.normal(0, 10)),
        "vel_e_m_s": float(rng.normal(0, 10)),
        "vel_d_m_s": float(rng.normal(0, 2)),
        "cog": float(rng.uniform(0, 2 * np.pi)),
        "cog_variance_rad": float(rng.uniform(0, 1)),
        "s_variance_m_s": float(rng.uniform(0, 5)),
        "timestamp": int(rng.integers(1_600_000_000, 1_900_000_000) * 1e6
                         + rng.integers(0, 1_000_000)),
        "eph": float(rng.uniform(0.5, 20)),
        "epv": float(rng.uniform(0.5, 20)),
        "satellites_visible": 255,
    }


SEEDS = list(range(6))


@pytest.mark.parametrize("include_velocity", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_nmea_block_equals_jax(seed, include_velocity):
    fix = _fix(seed)
    got = nmea.sentences_for_fix(include_velocity=include_velocity, **fix)
    want = jax_nmea.sentences_for_fix(include_velocity=include_velocity,
                                      **fix)
    assert [s.encode() for s in got] == [s.encode() for s in want]
    assert all(nmea.nmea_checksum(s[1:s.index("*")]) == s[-2:] for s in got)


@pytest.mark.parametrize("seed", SEEDS)
def test_ubx_nav_pvt_equals_jax(seed):
    fix = _fix(seed)
    got, want = ubx.make_nav_pvt(**fix), jax_ubx.make_nav_pvt(**fix)
    assert got == want
    frame = ubx.frame_nav_pvt(got)
    assert frame == jax_ubx.frame_nav_pvt(want)
    assert frame[:4] == b"\xb5\x62\x01\x07" and len(frame) == 100


@pytest.mark.parametrize("seed", SEEDS)
def test_uorb_sensor_gps_equals_jax(seed):
    fix = _fix(seed)
    got, want = uorb.make_sensor_gps(**fix), jax_uorb.make_sensor_gps(**fix)
    assert got == want
    assert {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in want.items()}
    assert got["satellites_used"] == 255
