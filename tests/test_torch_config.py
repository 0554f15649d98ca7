"""The port's config schema and registry mirror the reference's."""

import dataclasses

import pytest

from repro.configs import get_config as jget
from repro.models import config as jconfig
from repro_torch.configs import _PENDING, ARCH_IDS, get_config as tget
from repro_torch.kernels import flash_attention as flash_k
from repro_torch.kernels import paged_attention as paged_k
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


PORTED = ("llama3.2-1b", "olmoe-1b-7b", "qwen3-moe-30b-a3b", "chatglm3-6b",
          "gemma2-2b", "internlm2-20b")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", PORTED[1:3])
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


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", PORTED[3:])
def test_dense_config_equals_reference(arch, reduced):
    t = tget(arch, reduced=reduced)
    j = jget(arch, reduced=reduced)
    assert dataclasses.asdict(t) == _reference_dict(j)
    assert (t.num_layers, t.padded_vocab, t.has_moe, t.source) == \
        (j.num_layers, j.padded_vocab, False, j.source)


#: (layers, d_model, heads, KV heads, head dim, d_ff, vocab, tied,
#: rope theta, rope fraction, windows, soft-caps (attention, final),
#: embedding scale, post-norms) of the full-width configs
DENSE_NUMBERS = {
    "chatglm3-6b": (28, 4096, 32, 2, 128, 13696, 65024, False, 10000.0, 0.5,
                    (None,), (None, None), False, False),
    "gemma2-2b": (26, 2304, 8, 4, 256, 9216, 256000, True, 10000.0, 1.0,
                  (4096, None), (50.0, 30.0), True, True),
    "internlm2-20b": (48, 6144, 48, 8, 128, 16384, 92544, False, 1000000.0,
                      1.0, (None,), (None, None), False, False),
}


@pytest.mark.parametrize("arch", sorted(DENSE_NUMBERS))
def test_dense_full_width_numbers(arch):
    c = tget(arch)
    assert (c.num_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
            c.d_ff, c.vocab, c.tie_embeddings, c.rope_theta,
            c.pattern[0].rope_fraction, tuple(s.window for s in c.pattern),
            (c.pattern[0].logit_softcap, c.final_softcap), c.embed_scale,
            c.pattern[0].post_norm) == DENSE_NUMBERS[arch]


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a not in PORTED])
def test_unported_arch_names_its_queue_item(arch):
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        tget(arch)


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError):
        tget("no-such-arch")


def test_validate_raises_on_bad_heads():
    c = dataclasses.replace(tget("llama3.2-1b", reduced=True), n_kv_heads=3)
    with pytest.raises(ValueError):
        c.validate()


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if a not in _PENDING])
def test_every_ported_head_dim_has_its_kernels(arch, reduced):
    """Prefill and training attention on the card go through the flash
    kernels and decode through paged decode, neither with a fallback: a
    ported config whose head dim they are not built for would raise at
    its first prefill or train step on the card."""
    hd = tget(arch, reduced=reduced).head_dim
    assert hd in flash_k.KERNEL_HEAD_DIMS
    assert hd in paged_k.KERNEL_HEAD_DIMS
