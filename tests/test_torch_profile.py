"""``repro_torch.models.profile.profile_arch`` against the reference's:
every field of every layer profile at rtol 1e-12 (the cost model's NumPy
sums in another order, ROADMAP R2), with the training, dense-decode and
paged-decode KV accounting, on the paper's fleet and on a 32-type fleet.
Every reference config is checked through the port's schema and by id
(the port's own config of the same name)."""

import dataclasses

import numpy as np
import pytest

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.core import resources as jres
from repro.models.profile import profile_arch as jprofile
from repro_torch.configs import get_config as tget
from repro_torch.core import resources as tres
from repro_torch.models import config as tconfig
from repro_torch.models.profile import profile_arch as tprofile

FLEETS = {"paper": (jres.default_fleet(), tres.default_fleet()),
          "32 types": (jres.make_fleet(32), tres.make_fleet(32))}
#: (seq, decode kv len, kv cache len, kv page size)
MODES = {"train": (4096, None, None, None),
         "dense decode": (512, 300, 2048, None),
         "paged decode": (512, 5000, 8192, 16)}


def _port_config(cfg):
    """A reference ``ArchConfig`` in the port's schema."""
    kw = dataclasses.asdict(cfg)
    kw["pattern"] = tuple(tconfig.LayerSpec(**s) for s in kw["pattern"])
    if kw["encoder"] is not None:
        kw["encoder"] = tconfig.EncoderConfig(**kw["encoder"])
    return tconfig.ArchConfig(**kw)


def _assert_profiles_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.index, g.kind) == (w.index, w.kind)
        for f in ("flops", "input_bytes", "weight_bytes", "output_bytes",
                  "oct", "odt_sync", "odt_act", "alpha", "beta"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=1e-12, atol=0,
                                       err_msg=f"layer {g.index} {f}")


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("fleet", sorted(FLEETS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_profile_arch_matches_reference(arch, fleet, mode):
    seq, kv_len, cache_len, page = MODES[mode]
    jf, tf = FLEETS[fleet]
    kw = dict(seq=seq, decode_kv_len=kv_len, kv_cache_len=cache_len,
              kv_page_size=page)
    jcfg = jget(arch)
    want = jprofile(jcfg, jf, **kw)
    _assert_profiles_equal(tprofile(_port_config(jcfg), tf, **kw), want)
    _assert_profiles_equal(tprofile(arch, tf, **kw), want)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "llama-3.2-vision-11b",
                                  "rwkv6-7b", "whisper-large-v3"])
def test_profile_arch_takes_the_mixer_archs_by_id(arch):
    """The recurrent, hybrid, vision and audio archs by id, with the
    defaults of both packages, reduced and full: the port's own configs
    give the reference's profiles."""
    fleet_j, fleet_t = FLEETS["paper"]
    for reduced in (False, True):
        want = jprofile(jget(arch, reduced=reduced), fleet_j)
        got = tprofile(tget(arch, reduced=reduced), fleet_t)
        _assert_profiles_equal(got, want)
    _assert_profiles_equal(tprofile(arch, fleet_t),
                           jprofile(jget(arch), fleet_j))


def test_decode_accounting_moves_only_the_attention_rows():
    """Paged decode charges the used pages, dense the whole ring; gemma2's
    local layers read at most their window either way."""
    fleet = tres.default_fleet()
    base = tprofile("gemma2-2b", fleet, seq=8192)
    dense = tprofile("gemma2-2b", fleet, seq=8192, decode_kv_len=6001,
                     kv_cache_len=8192)
    paged = tprofile("gemma2-2b", fleet, seq=8192, decode_kv_len=6001,
                     kv_page_size=16)
    row = 2 * 4 * 256 * 4                           # k + v, 4 KV heads
    local, glob = dense[1], dense[2]                # layers 0 and 1
    assert local.input_bytes - base[1].input_bytes == 4096 * row
    assert glob.input_bytes - base[2].input_bytes == 8192 * row
    # positions 0..6000 fill 376 pages; the window's 4,096 positions
    # 1905..6000 start and end mid-page: 257 pages
    assert paged[2].input_bytes - base[2].input_bytes == 376 * 16 * row
    assert paged[1].input_bytes - base[1].input_bytes == 257 * 16 * row
    assert [p.flops for p in dense] == [p.flops for p in base]
