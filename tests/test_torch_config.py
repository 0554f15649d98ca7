"""The port's config schema and registry mirror the reference's."""

import dataclasses

import pytest

from repro.configs import get_config as jget
from repro.models import config as jconfig
from repro_torch.configs import ARCH_IDS, get_config as tget
from repro_torch.models import config as tconfig


def _fields(cls):
    return [(f.name, f.default, f.default_factory, str(f.type))
            for f in dataclasses.fields(cls)]


#: the port's one field of its own: ArchConfig.attn_impl picks the flash
#: attention path (the reference's attention has no kernel to pick), and
#: it sits right after moe_impl
PORT_ONLY = {"ArchConfig": ("moe_impl", ("attn_impl", "auto",
                                         dataclasses.MISSING, "str"))}


def _reference_fields(name):
    fields = _fields(getattr(jconfig, name))
    if name in PORT_ONLY:
        after, field = PORT_ONLY[name]
        at = [f[0] for f in fields].index(after) + 1
        fields.insert(at, field)
    return fields


def _reference_dict(cfg):
    return {**dataclasses.asdict(cfg), "attn_impl": "auto"}


@pytest.mark.parametrize("name", ["LayerSpec", "EncoderConfig", "ArchConfig"])
def test_fields_match_reference(name):
    assert _fields(getattr(tconfig, name)) == _reference_fields(name)


@pytest.mark.parametrize("reduced", [False, True])
def test_llama_config_equals_reference(reduced):
    t = tget("llama3.2-1b", reduced=reduced)
    j = jget("llama3.2-1b", reduced=reduced)
    assert dataclasses.asdict(t) == _reference_dict(j)
    assert (t.num_layers, t.padded_vocab, t.has_moe) == \
        (j.num_layers, j.padded_vocab, j.has_moe)


def test_full_width_numbers():
    c = tget("llama3.2-1b")
    assert (c.num_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
            c.d_ff, c.vocab, c.tie_embeddings, c.rope_theta) == \
        (16, 2048, 32, 8, 64, 8192, 128256, True, 500000.0)


PORTED = ("llama3.2-1b", "olmoe-1b-7b", "qwen3-moe-30b-a3b")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", PORTED[1:])
def test_moe_config_equals_reference(arch, reduced):
    t = tget(arch, reduced=reduced)
    j = jget(arch, reduced=reduced)
    assert dataclasses.asdict(t) == _reference_dict(j)
    assert (t.num_layers, t.padded_vocab, t.has_moe) == \
        (j.num_layers, j.padded_vocab, True)


def test_olmoe_full_width_numbers():
    c = tget("olmoe-1b-7b")
    assert (c.num_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
            c.moe_experts, c.moe_top_k, c.moe_d_ff, c.vocab, c.padded_vocab,
            c.tie_embeddings, c.pattern[0].qk_norm) == \
        (16, 2048, 16, 16, 128, 64, 8, 1024, 50304, 50432, False, True)


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a not in PORTED])
def test_unported_arch_names_its_queue_item(arch):
    with pytest.raises(NotImplementedError, match="queue 1 item"):
        tget(arch)


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError):
        tget("no-such-arch")


def test_validate_raises_on_bad_heads():
    c = dataclasses.replace(tget("llama3.2-1b", reduced=True), n_kv_heads=3)
    with pytest.raises(ValueError):
        c.validate()
