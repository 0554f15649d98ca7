"""The port's config schema and registry mirror the reference's."""

import dataclasses

import pytest

from repro.configs import get_config as jget
from repro.models import config as jconfig
from repro_torch.configs import ARCH_IDS, get_config as tget
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


MIXER_ARCHS = ("rwkv6-7b", "jamba-v0.1-52b", "llama-3.2-vision-11b",
               "whisper-large-v3")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_mixer_config_equals_reference(arch, reduced):
    t = tget(arch, reduced=reduced)
    j = jget(arch, reduced=reduced)
    assert dataclasses.asdict(t) == _reference_dict(j)
    assert (t.num_layers, t.padded_vocab, t.has_moe, t.source) == \
        (j.num_layers, j.padded_vocab, j.has_moe, j.source)


#: (layers, d_model, heads, KV heads, head dim, d_ff, vocab, the
#: pattern's mixers and FFNs, positions, norm, tied, experts / top-k,
#: Mamba (d_state, d_conv, expand), RWKV head size, encoder (layers,
#: frames), cross_kv_len) of the full-width configs
MIXER_NUMBERS = {
    "rwkv6-7b": (32, 4096, 64, 64, 64, 14336, 65536, (("rwkv",
                 "channel_mix"),), "none", "rms", False, (0, 0),
                 (16, 4, 2), 64, None, 0),
    "jamba-v0.1-52b": (32, 4096, 32, 8, 128, 14336, 65536,
                       tuple(("attn" if i == 3 else "mamba",
                              "moe" if i % 2 else "dense")
                             for i in range(8)), "none", "rms", False,
                       (16, 2), (16, 4, 2), 64, None, 0),
    "llama-3.2-vision-11b": (40, 4096, 32, 8, 128, 14336, 128256,
                             (("attn", "dense"),) * 4
                             + (("cross_attn", "dense"),), "rope", "rms",
                             False, (0, 0), (16, 4, 2), 64, None, 1601),
    "whisper-large-v3": (32, 1280, 20, 20, 64, 5120, 51866,
                         (("attn+cross", "dense"),), "learned", "ln", True,
                         (0, 0), (16, 4, 2), 64, (32, 1500), 1500),
}


@pytest.mark.parametrize("arch", MIXER_ARCHS)
def test_mixer_full_width_numbers(arch):
    """The four archs of the recurrent and encoder mixers at full width
    (jamba-v0.1-52b: 4 repeats of its 8-layer period, MoE on every second
    layer; llama-3.2-vision-11b: every fifth layer cross-attention)."""
    c = tget(arch)
    enc = (c.encoder.num_layers, c.encoder.frames) if c.encoder else None
    assert (c.num_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
            c.d_ff, c.vocab, tuple((s.mixer, s.ffn) for s in c.pattern),
            c.pos_embed, c.norm, c.tie_embeddings,
            (c.moe_experts, c.moe_top_k),
            (c.mamba_d_state, c.mamba_d_conv, c.mamba_expand),
            c.rwkv_head_size, enc, c.cross_kv_len) == MIXER_NUMBERS[arch]


def test_unknown_arch_raises_key_error():
    with pytest.raises(KeyError):
        tget("no-such-arch")


def test_validate_raises_on_bad_heads():
    c = dataclasses.replace(tget("llama3.2-1b", reduced=True), n_kv_heads=3)
    with pytest.raises(ValueError):
        c.validate()


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_ported_head_dim_has_its_kernels(arch, reduced):
    """Prefill and training attention on the card go through the flash
    kernels and decode through paged decode, neither with a fallback: a
    ported config whose head dim they are not built for would raise at
    its first prefill or train step on the card."""
    hd = tget(arch, reduced=reduced).head_dim
    assert hd in flash_k.KERNEL_HEAD_DIMS
    assert hd in paged_k.KERNEL_HEAD_DIMS
