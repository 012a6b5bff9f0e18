"""Random weights of a VoiceCraft configuration, made on the device from the
seed in a few large calls, in the types they are served in.

The state is keyed as the port's checkpoints are (the layout that
``VoiceCraft.load_state_dict`` reads) and is handed to the port through that
public load path, and to the reference.  Matrices are drawn per kind for
all layers at once, with the fan-in bounds of the published initialisation;
every bias and norm parameter is drawn too (not left at 0 or 1), so that a
path that drops one shows in the logits.
"""

from __future__ import annotations

from typing import Dict

import torch

FLOAT = torch.float32


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (2 ** 63))


def make_state(cfg: dict, seed: int, device, matrix_dtype: torch.dtype
               ) -> Dict[str, torch.Tensor]:
    """The weights of ``cfg`` (a configuration file's dict) for ``seed``:
    decoder and head matrices in ``matrix_dtype`` (the decoder's biases
    too), embeddings, alphas, norm parameters and head biases in f32."""
    g = _gen(seed, device)
    L, D = cfg["num_decoder_layers"], cfg["d_model"]
    Fd, K = 4 * D, cfg["n_codebooks"]
    card = cfg["audio_vocab_size"] + cfg["n_special"]
    half = cfg["audio_vocab_size"] // 2
    n_text = cfg["text_vocab_size"] + 1

    def uni(shape, bound, dtype=matrix_dtype):
        t = torch.rand(shape, generator=g, device=device, dtype=FLOAT)
        return t.mul_(2 * bound).sub_(bound).to(dtype)

    def normal(shape):
        return torch.randn(shape, generator=g, device=device, dtype=FLOAT)

    st = {"text_emb": normal((n_text, D)), "audio_emb": normal((K, card, D)),
          "mask_emb": normal((cfg["max_n_spans"], D)),
          "alpha_text": 1.0 + uni((), 0.1, FLOAT),
          "alpha_audio": 1.0 + uni((), 0.1, FLOAT)}
    xavier = (6.0 / (4 * D)) ** 0.5
    qkv = uni((L, 3, D, D), xavier)
    wo, w1, w2 = uni((L, D, D), D ** -0.5), uni((L, D, Fd), D ** -0.5), \
        uni((L, Fd, D), Fd ** -0.5)
    b_attn = uni((L, 4, D), D ** -0.5)
    b1, b2 = uni((L, Fd), D ** -0.5), uni((L, D), Fd ** -0.5)
    gains = 1.0 + uni((L + 1, 2, D), 0.1, FLOAT)
    shifts = uni((L + 1, 2, D), 0.1, FLOAT)
    for i in range(L):
        p = f"decoder.layers.{i}."
        st.update({p + "ln1_g": gains[i, 0], p + "ln1_b": shifts[i, 0],
                   p + "wq": qkv[i, 0], p + "wk": qkv[i, 1],
                   p + "wv": qkv[i, 2], p + "bq": b_attn[i, 0],
                   p + "bk": b_attn[i, 1], p + "bv": b_attn[i, 2],
                   p + "wo": wo[i], p + "bo": b_attn[i, 3],
                   p + "ln2_g": gains[i, 1], p + "ln2_b": shifts[i, 1],
                   p + "w1": w1[i], p + "b1": b1[i], p + "w2": w2[i],
                   p + "b2": b2[i]})
    st["decoder.final_ln_g"] = gains[L, 0]
    st["decoder.final_ln_b"] = shifts[L, 0]
    st.update({"heads.w1": uni((K, D, half), D ** -0.5),
               "heads.b1": uni((K, half), D ** -0.5, FLOAT),
               "heads.w2": uni((K, half, card), half ** -0.5),
               "heads.b2": uni((K, card), half ** -0.5, FLOAT)})
    return st
