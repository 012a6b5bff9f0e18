"""A tiny Whisper snapshot built offline, for the tests of the port's
Whisper glue (utils/transcribe.py, align.py and the CLIs' --asr-model /
--wer): a byte-level vocabulary with Whisper's special tokens, a
WhisperConfig with d_model 32 and one layer each side, and the alignment
heads in generation_config.json (without ``_from_model_config``, with
which ``from_pretrained`` drops them).  Its weights are random but for the
decoder, which is set so that greedy decoding writes ``TEXT`` whatever the
audio: unit zero-mean token embeddings (tied to the output projection),
the decoder layer's residual branches off, and each position's embedding
a large multiple of the token it should emit next."""

import json
import os

import torch

TEXT = " the sound of birds"
SPECIALS = ["<|startoftranscript|>", "<|en|>", "<|translate|>",
            "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
            "<|nospeech|>", "<|notimestamps|>"]


def make_tiny_whisper(out: str, text: str = TEXT, seed: int = 0) -> str:
    from transformers import (WhisperConfig, WhisperFeatureExtractor,
                              WhisperForConditionalGeneration,
                              WhisperProcessor, WhisperTokenizer)
    from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode
    os.makedirs(out, exist_ok=True)
    b2u = bytes_to_unicode()
    vocab, merges = os.path.join(out, "vocab.json"), os.path.join(out,
                                                                  "merges.txt")
    with open(vocab, "w") as f:
        json.dump({b2u[b]: b for b in range(256)}, f)
    with open(merges, "w") as f:
        f.write("#version: 0.2\n")
    eot = "<|endoftext|>"
    tok = WhisperTokenizer(vocab, merges, unk_token=eot, bos_token=eot,
                           eos_token=eot, pad_token=eot)
    tok.add_special_tokens({"additional_special_tokens": SPECIALS})
    WhisperProcessor(WhisperFeatureExtractor(feature_size=80),
                     tok).save_pretrained(out)
    ids = tok.convert_tokens_to_ids
    cfg = WhisperConfig(
        vocab_size=len(tok), d_model=32, encoder_layers=1, decoder_layers=1,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=64, decoder_ffn_dim=64, num_mel_bins=80,
        max_target_positions=64,
        decoder_start_token_id=ids("<|startoftranscript|>"),
        eos_token_id=ids(eot), pad_token_id=ids(eot), bos_token_id=ids(eot),
        begin_suppress_tokens=None, suppress_tokens=None)
    torch.manual_seed(seed)
    model = WhisperForConditionalGeneration(cfg)
    dec = model.model.decoder
    want = ([ids("<|startoftranscript|>"), ids("<|notimestamps|>")]
            + tok.encode(text, add_special_tokens=False) + [ids(eot)])
    with torch.no_grad():
        e = torch.randn(len(tok), cfg.d_model)
        e = e - e.mean(1, keepdim=True)
        dec.embed_tokens.weight.copy_(e / e.norm(dim=1, keepdim=True))
        layer = dec.layers[0]
        for lin in (layer.self_attn.out_proj, layer.encoder_attn.out_proj,
                    layer.fc2):
            lin.weight.zero_()
            lin.bias.zero_()
        pos = dec.embed_positions.weight
        pos.zero_()
        for t in range(1, len(want)):
            pos[t - 1] = 30.0 * dec.embed_tokens.weight[want[t]]
    model.generation_config.alignment_heads = [[0, 0], [0, 1]]
    model.save_pretrained(out)
    path = os.path.join(out, "generation_config.json")
    with open(path) as f:
        gen = json.load(f)
    gen.pop("_from_model_config", None)
    with open(path, "w") as f:
        json.dump(gen, f)
    return out
