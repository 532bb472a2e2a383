"""The port's observation ingest against the JAX package's, on the CPU.

Writers, the Python parsers and the port's native parser
(``cwbnwp_letkf_torch/csrc/gts_parser.cpp``, built into the port's
``_build/``), the obs_gts altitude file, and the ensemble readers: the same
seeded records go through both packages.  Parsed records and ``PlatformObs``
arrays are held exactly, except the projected x and y, which the port computes
in numpy float32 and JAX in XLA float32: they are held to 4 ulps of rh0
(tests/test_torch_driver.py's limit for analysis points).
"""
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest

from cwbnwp_letkf_tpu.config import ProjectionConfig as JProjectionConfig
from cwbnwp_letkf_tpu.obs import gts as jgts
from cwbnwp_letkf_tpu.obs import radar as jradar
from cwbnwp_letkf_tpu.projection import LambertProjection as JLambert
from cwbnwp_letkf_torch.config import ProjectionConfig
from cwbnwp_letkf_torch.io import native
from cwbnwp_letkf_torch.obs import gts, radar
from cwbnwp_letkf_torch.projection import LambertProjection

from .test_obs_gts_alt import (HEADER, SOUND_HEIGHTS, _each, _info, _srfc,
                               _write_fixture)

K = 3
XY_ULPS = 4
PROJ = dict(cen_lon=120.0, cen_lat=23.7, truelat1=10.0, truelat2=40.0,
            sta_lon=120.0)
#: family -> (station ids, level of each record): the ids the obs_gts
#: fixture of tests/test_obs_gts_alt.py holds, multi-level reports
#: restarting at level 1, and the two families whose slot is an altitude
FAMILIES = {
    "synop": (["46692", "46693"], [1, 1]),
    "metar": (["RCTP"], [1]),
    "buoy": (["B0001"], [1]),
    "sound": (["46699"] * 4 + ["46699"] * 2, [1, 2, 3, 4, 1, 2]),
    "gpspw": (["GPS001", "GPS002"], [1, 1]),
    "gpsref": (["GR01"] * 3 + ["GR02"] * 2, [1, 2, 3, 1, 2]),
}


def _records(pkg, rng, name, omb_seed=None):
    """One family's records as ``pkg.GtsRecords`` (the metadata from
    ``rng``; the omb columns from ``omb_seed`` when given)."""
    ids, levels = FAMILIES[name]
    nvar = jgts.FAMILY[name][1]
    rec = pkg.GtsRecords()
    orng = np.random.default_rng(omb_seed) if omb_seed is not None else rng
    for ident, lev in zip(ids, levels):
        rec.ids.append(ident)
        rec.lat.append(float(rng.uniform(23.0, 24.5)))
        rec.lon.append(float(rng.uniform(119.5, 121.5)))
        rec.pre.append(float(rng.uniform(100.0, 1015.0)))
        rec.obs.append([float(rng.normal(0, 5)) for _ in range(nvar)])
        rec.qc.append([int(rng.integers(-2, 3)) for _ in range(nvar)])
        rec.err.append([float(rng.uniform(0.5, 2)) for _ in range(nvar)])
        rec.level.append(lev)
        rec.omb.append([float(orng.normal(0, 1)) for _ in range(nvar)])
    return rec


def _families(pkg, seed, omb_seed=None, names=tuple(FAMILIES)):
    rng = np.random.default_rng(seed)
    return {name: _records(pkg, rng, name, omb_seed) for name in names}


def _member_files(pkg, d, prefix="gts_letkf", names=tuple(FAMILIES), k=K,
                  seed=0):
    """``k`` member files written by ``pkg``: the same records, each member
    with its own omb columns."""
    paths = []
    for m in range(k):
        p = str(d / f"{prefix}_{m + 1:03d}")
        pkg.write_member_file(p, _families(pkg, seed, omb_seed=100 + m,
                                           names=names))
        paths.append(p)
    return paths


def _radar_data(rng, n):
    data = np.stack([rng.normal(10, 20, n), rng.normal(10, 20, n),
                     rng.uniform(119.5, 121.5, n), rng.uniform(23.0, 24.5, n),
                     rng.uniform(0.0, 1.2e4, n)], 1)
    return np.round(data.astype(np.float32), 4)


def _projections():
    return (LambertProjection.from_config(ProjectionConfig(**PROJ)),
            JLambert.from_config(JProjectionConfig(**PROJ)))


def _assert_obs_equal(po, jpo, proj):
    """Every array exact, x and y within XY_ULPS of rh0."""
    for name in ("obs", "error", "qc", "hdxb"):
        got, want = getattr(po, name), np.asarray(getattr(jpo, name))
        assert got.dtype == want.dtype == np.float32, name
        assert np.array_equal(got, want), name
    want = np.asarray(jpo.xyz)
    assert po.xyz.dtype == want.dtype == np.float32
    assert np.array_equal(po.xyz[:, 2], want[:, 2])
    tol = XY_ULPS * float(np.spacing(np.float32(proj.rh0)))
    np.testing.assert_allclose(po.xyz[:, :2], want[:, :2], rtol=0, atol=tol)


def test_gts_writer_bytes_equal(tmp_path):
    """Single- and multi-level families and the altitude slots."""
    a, b = tmp_path / "port", tmp_path / "jax"
    gts.write_member_file(str(a), _families(gts, 1))
    jgts.write_member_file(str(b), _families(jgts, 1))
    assert a.read_bytes() == b.read_bytes()
    text = a.read_text()
    assert f"{'sound':<20s}{2:8d}" in text and f"{'gpsref':<20s}{2:8d}" in text


@pytest.mark.parametrize("n", [0, 1, 37])
def test_radar_writer_bytes_equal(tmp_path, n):
    data = _radar_data(np.random.default_rng(2 + n), n)
    radar.write_radar_file(str(tmp_path / "port"), data)
    jradar.write_radar_file(str(tmp_path / "jax"), data)
    assert ((tmp_path / "port").read_bytes()
            == (tmp_path / "jax").read_bytes())


def _as_arrays(rec):
    """A family's records as float32 / int arrays (the native layout)."""
    return dict(ids=list(rec.ids), level=np.asarray(rec.level, np.int32),
                qc=np.asarray(rec.qc, np.int32),
                **{f: np.asarray(getattr(rec, f), np.float32)
                   for f in ("lat", "lon", "pre", "obs", "omb", "err")})


def test_gts_parsers_equal(tmp_path):
    """The port's Python parser equals JAX's record for record; the port's
    native parser equals it in float32."""
    path = str(tmp_path / "gts_letkf_001")
    jgts.write_member_file(path, _families(jgts, 3))
    want = jgts.parse_member_file(path)
    got = gts.parse_member_file(path)
    nat = native.parse_member_file_native(path)
    assert list(got) == list(want) == list(FAMILIES)
    assert set(nat) == set(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name])
        w = _as_arrays(want[name])
        n = nat[name]
        assert list(n.ids) == w["ids"], name
        for f in w:
            if f != "ids":
                assert np.array_equal(getattr(n, f), w[f]), (name, f)
    assert list(nat["sound"].level) == FAMILIES["sound"][1]


@pytest.mark.parametrize("n", [0, 1, 37])
def test_radar_parsers_equal(tmp_path, n):
    path = str(tmp_path / "VR_letkf_001")
    jradar.write_radar_file(path, _radar_data(np.random.default_rng(n), n))
    want = jradar.parse_radar_file(path)
    got = radar.parse_radar_file(path)
    nat = native.parse_radar_file_native(path)
    fast = radar.parse_radar_file_fast(path)
    if n == 0:
        assert want is None and got is None and fast is None
        assert nat.shape == (0, 5)
        return
    assert np.array_equal(got, want) and np.array_equal(nat, want)
    assert np.array_equal(fast, want)


def test_radar_blank_file(tmp_path):
    path = tmp_path / "MR_letkf_001"
    path.write_text("")
    assert radar.parse_radar_file(str(path)) is None
    assert jradar.parse_radar_file(str(path)) is None
    assert radar.parse_radar_file_fast(str(path)) is None


@pytest.mark.parametrize("fmt", [
    "(3(F12.3,I4,F7.2),11X,3(F12.3,I4,F7.2))",
    "(A12,1X,A19,1X,A40,1X,I6,3(F12.3,11X),6X,A40)",
    "(F12.3,I4,F7.2,F12.3,I4,F7.3)",
    "(2I8, A5, 2F9.2)",
])
def test_fortran_format_equal(fmt):
    ops = gts.parse_fortran_format(fmt)
    assert ops == jgts.parse_fortran_format(fmt)
    line = _each(1476.9) + _info("FM-35 TEMP", "2018-06-27_12:00:00", "S",
                                 4, 25.0, 121.5, 24.0, "46699")
    for text in (line, "", "   12"):
        try:
            want = jgts.read_fortran_fields(text, ops)
        except ValueError:
            with pytest.raises(ValueError):
                gts.read_fortran_fields(text, ops)
            continue
        assert gts.read_fortran_fields(text, ops) == want


def _tables_equal(table, jtable):
    assert ({int(p): ids for p, ids in table._tab.items()}
            == {int(p): ids for p, ids in jtable._tab.items()})


def test_parse_obs_gts_verbatim_fixture(tmp_path):
    fix = tmp_path / "obs_gts"
    _write_fixture(fix)
    table = gts.parse_obs_gts(str(fix))
    _tables_equal(table, jgts.parse_obs_gts(str(fix)))
    for lev, h in enumerate(SOUND_HEIGHTS, start=1):
        assert table.get(gts.GtsType.SOUND, "46699", lev) == pytest.approx(h)
    assert table.get(gts.GtsType.GPSPW, "GPS001", 1) == pytest.approx(112.5)
    with pytest.raises(KeyError):
        table.get(gts.GtsType.SYNOP, "99999", 1)


def _unknown_fm_lines(header_altitude):
    if header_altitude:
        # claims 3 levels but writes only INFO + SRFC, like GPSPW
        head = [_info("FM-99 ODDPW", "2018-06-27_12:00:00", "MYSTERY", 3,
                      25.0, 121.0, 88.0, "ZZ9"), _srfc(pw=31.2)]
    else:
        head = [_info("FM-88 WEIRD", "2018-06-27_12:00:00", "MYSTERY", 2,
                      25.0, 121.0, 0.0, "XX1"), _srfc(), _each(1.0),
                _each(2.0)]
    return [HEADER.rstrip("\n")] + head + [
        _info("FM-12 SYNOP", "2018-06-27_12:00:00", "SURFACE", 1,
              25.0, 121.0, 7.0, "46700"), _srfc(), _each(7.0),
        _info("FM-35 TEMP", "2018-06-27_12:00:00", "SOUNDING", 2,
              25.0, 121.0, 5.0, "46701"), _srfc(), _each(10.0),
        _each(1500.0)]


@pytest.mark.parametrize("header_altitude", [False, True])
def test_parse_obs_gts_unknown_fm(tmp_path, header_altitude):
    """tests/test_obs_gts_alt.py:124-190: an unknown FM code raises in both
    packages with the same message; the skip resyncs on the next INFO
    line and both read the same table."""
    fix = tmp_path / "obs_gts"
    fix.write_text("\n".join(_unknown_fm_lines(header_altitude)) + "\n")
    with pytest.raises(ValueError, match="unknown FM code") as got:
        gts.parse_obs_gts(str(fix))
    with pytest.raises(ValueError) as want:
        jgts.parse_obs_gts(str(fix))
    assert str(got.value) == str(want.value)
    table = gts.parse_obs_gts(str(fix), on_unknown_fm="skip")
    _tables_equal(table, jgts.parse_obs_gts(str(fix), on_unknown_fm="skip"))
    assert table.get(gts.GtsType.SYNOP, "46700", 1) == pytest.approx(7.0)
    assert table.get(gts.GtsType.SOUND, "46701", 2) == pytest.approx(1500.0)


def test_parse_obs_gts_refuses_non_obs_gts(tmp_path):
    fix = tmp_path / "obs_gts"
    fix.write_text("not an obs_gts file\n")
    with pytest.raises(ValueError, match="no 'EACH' header"):
        gts.parse_obs_gts(str(fix))
    with pytest.raises(ValueError, match="on_unknown_fm"):
        gts.parse_obs_gts(str(fix), on_unknown_fm="ignore")


@pytest.mark.parametrize("alt", ["obs_gts", "none"])
def test_read_gts_ensemble_equal(tmp_path, alt):
    """All six families over K members, with the obs_gts altitude join (or
    none), through the projection of each package."""
    paths = _member_files(jgts, tmp_path)
    table = jtable = None
    if alt == "obs_gts":
        _write_fixture(tmp_path / "obs_gts")
        table = gts.parse_obs_gts(str(tmp_path / "obs_gts"))
        jtable = jgts.parse_obs_gts(str(tmp_path / "obs_gts"))
    proj, jproj = _projections()
    native.reset_parses()
    got = gts.read_gts_ensemble(paths, proj, table)
    assert native.PARSES == {"native": K, "python": 0}
    want = jgts.read_gts_ensemble(paths, jproj, jtable)
    assert list(got) == list(want) == list(FAMILIES)
    for name in want:
        _assert_obs_equal(got[name], want[name], proj)
    if alt == "obs_gts":
        np.testing.assert_array_equal(got["sound"].xyz[:, 2],
                                      np.float32(SOUND_HEIGHTS + [24.0, 512.3]))
    else:
        assert not got["synop"].xyz[:, 2].any()
    slot = jgts.parse_member_file(paths[0])["gpsref"].pre
    assert np.array_equal(got["gpsref"].xyz[:, 2],
                          np.asarray(slot, np.float32))


def test_read_gts_ensemble_python_parser(tmp_path, monkeypatch):
    """Without the native library the Python parser serves every file and
    gives the same arrays."""
    paths = _member_files(jgts, tmp_path)
    _write_fixture(tmp_path / "obs_gts")
    table = gts.parse_obs_gts(str(tmp_path / "obs_gts"))
    proj, _ = _projections()
    want = gts.read_gts_ensemble(paths, proj, table)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_LIB_FAILED", True)
    native.reset_parses()
    got = gts.read_gts_ensemble(paths, proj, table)
    assert native.PARSES == {"native": 0, "python": K}
    for name in want:
        for f in want[name]._fields:
            assert np.array_equal(getattr(got[name], f),
                                  getattr(want[name], f)), (name, f)


def test_read_radar_ensemble_equal(tmp_path):
    rng = np.random.default_rng(4)
    base = _radar_data(rng, 53)
    paths = []
    for m in range(K):
        data = base.copy()
        data[:, 1] = np.round(rng.normal(10, 20, 53).astype(np.float32), 4)
        paths.append(str(tmp_path / f"MR_letkf_{m + 1:03d}"))
        jradar.write_radar_file(paths[-1], data)
    proj, jproj = _projections()
    native.reset_parses()
    got = radar.read_radar_ensemble(paths, proj)
    assert native.PARSES == {"native": K, "python": 0}
    _assert_obs_equal(got, jradar.read_radar_ensemble(paths, jproj), proj)
    assert radar.PREFIX_TO_NAME == jradar.PREFIX_TO_NAME


def test_read_radar_ensemble_empty(tmp_path):
    paths = []
    for m in range(K):
        paths.append(str(tmp_path / f"VR_letkf_{m + 1:03d}"))
        jradar.write_radar_file(paths[-1], np.zeros((0, 5), np.float32))
    proj, jproj = _projections()
    assert radar.read_radar_ensemble(paths, proj) is None
    assert jradar.read_radar_ensemble(paths, jproj) is None


def _refusal_case(tmp_path, pkg, kind):
    """``(call, error type)`` of one refusal, over files ``pkg`` wrote."""
    proj = _projections()[pkg is jgts]
    if kind == "member count":
        d = tmp_path / "count"
        d.mkdir(exist_ok=True)
        paths = _member_files(pkg, d, names=("synop",), k=2)
        pkg.write_member_file(paths[1], {"synop": _records(
            pkg, np.random.default_rng(0), "metar")})
        return lambda: pkg.read_gts_ensemble(paths, proj), ValueError
    if kind == "radar count":
        paths = [str(tmp_path / f"VR_letkf_{m + 1:03d}") for m in range(2)]
        rmod = jradar if pkg is jgts else radar
        for m, n in enumerate((5, 4)):
            rmod.write_radar_file(
                paths[m], _radar_data(np.random.default_rng(m), n))
        return lambda: rmod.read_radar_ensemble(paths, proj), ValueError
    d = tmp_path / kind.replace(" ", "_")
    d.mkdir(exist_ok=True)
    table = pkg.AltTable()
    if kind == "unknown id":
        _write_fixture(tmp_path / "obs_gts")
        table = pkg.parse_obs_gts(str(tmp_path / "obs_gts"))
        paths = _member_files(pkg, d, names=("synop",), k=2)
        for p in paths:   # a station the fixture lacks
            Path(p).write_text(Path(p).read_text().replace("46693", "NOPE "))
    else:   # the table has METAR only
        table.add(pkg.GtsType.METAR, "RCTP", [33.5])
        paths = _member_files(pkg, d, names=("synop",), k=2)
    return lambda: pkg.read_gts_ensemble(paths, proj, table), KeyError


@pytest.mark.parametrize("kind", ["unknown id", "missing family",
                                  "member count", "radar count"])
def test_refusals_as_jax(tmp_path, kind):
    """An unknown station id, a family missing from obs_gts and an
    inconsistent member count raise as the JAX package's readers do.  The
    port has no opt-out for a missing family, so its message lacks the JAX
    one's hint at ``allow_missing_alt``."""
    call, exc = _refusal_case(tmp_path, gts, kind)
    with pytest.raises(exc) as got:
        call()
    jcall, _ = _refusal_case(tmp_path, jgts, kind)
    with pytest.raises(exc) as want:
        jcall()
    hint = "; pass allow_missing_alt=True to force altitude 0"
    if kind == "missing family":
        assert want.value.args[0].endswith(hint)
    assert got.value.args[0] == want.value.args[0].removesuffix(hint)


def test_native_library_is_the_ports(tmp_path):
    """The library loads from the port's own ``_build/``, built from the
    port's ``csrc/gts_parser.cpp``, whose code is the root copy's (only the
    header comment differs)."""
    pkg = Path(native.__file__).resolve().parent.parent
    lib = native.get_library()
    assert lib is not None
    assert Path(lib._name).resolve() == pkg / "_build" / "libobsparse.so"
    assert Path(native._SRC).resolve() == pkg / "csrc" / "gts_parser.cpp"
    assert os.path.getmtime(lib._name) >= os.path.getmtime(native._SRC)

    def code(path):
        lines = path.read_text().splitlines()
        return lines[next(i for i, s in enumerate(lines)
                          if not s.startswith("//")):]

    assert code(pkg / "csrc" / "gts_parser.cpp") == code(
        pkg.parent / "csrc" / "gts_parser.cpp")
