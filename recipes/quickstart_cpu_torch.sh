#!/bin/bash
# The PyTorch port's twin of recipes/quickstart_cpu.sh: end-to-end smoke
# of the WHOLE pipeline on CPU with random weights:
#   synthesize a toy corpus -> preprocess_torch_cli -> train_torch_cli
#   (tiny model, a few steps) -> tts_torch_cli zero-shot synthesis from the
#   checkpoint.
# No checkpoints, no GPU, no network.  This is the fastest way to check an
# install of the port and see every stage's artifacts.
set -e
WORK=${1:-/tmp/voicecraft_tpu_torch_quickstart}
rm -rf "$WORK" && mkdir -p "$WORK/corpus"

# toy corpus: three sine-ish utterances + transcripts
python - "$WORK/corpus" <<'EOF'
import sys, wave, numpy as np
out = sys.argv[1]
rng = np.random.default_rng(0)
texts = ["hello world this is a test",
         "the quick brown fox jumps over the lazy dog",
         "speech synthesis from scratch on tensor processing units"]
for i, text in enumerate(texts):
    t = np.arange(16000 * 2) / 16000.0
    f = 180 + 60 * i
    w = 0.2 * np.sin(2 * np.pi * f * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    pcm = np.round(w * 32767).astype("<i2")
    with wave.open(f"{out}/utt{i}.wav", "wb") as wf:
        wf.setnchannels(1); wf.setsampwidth(2); wf.setframerate(16000)
        wf.writeframes(pcm.tobytes())
    open(f"{out}/utt{i}.txt", "w").write(text)
print("corpus written")
EOF

python preprocess_torch_cli.py --audio-dir "$WORK/corpus" --out-dir "$WORK/data" \
  --random-init --codec-bins 128 --text-backend grapheme --device cpu

python train_torch_cli.py --preset tiny_test --exp-dir "$WORK/exp" \
  --dataset-dir "$WORK/data" --num-steps 20 --max-num-tokens 2000 \
  --num-buckets 2 --val-every-n-steps 10 --device cpu

python tts_torch_cli.py --model "$WORK/exp/ckpt_latest" --random-init \
  --text-backend grapheme --device cpu \
  --prompt-wav "$WORK/corpus/utt0.wav" \
  --prompt-transcript "hello world this is a test" \
  --target-transcript "hello world this is a brand new sentence" \
  --out "$WORK/out.wav"

echo "quickstart OK: $WORK/out.wav"
