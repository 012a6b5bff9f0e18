#!/bin/bash
# The PyTorch port's twin of recipes/edit_demo.sh: the speech-editing
# golden path on the committed demo fixture (demo/): substitution,
# insertion, and deletion edits through edit_torch_cli with the committed
# word-alignment CSV — runnable out of the box on CPU with random weights
# (machinery check; use converted checkpoints for real audio).  Mirrors
# the reference's inference_speech_editing.ipynb + demo/ fixtures.
set -e
cd "$(dirname "$0")/.."
OUT=${1:-/tmp/voicecraft_tpu_torch_edit_demo}
mkdir -p "$OUT"
run_edit() {
  python edit_torch_cli.py --model tiny_test --random-init --device cpu \
    --text-backend grapheme \
    --wav demo/demo.wav --mfa-csv demo/demo_alignment.csv \
    --orig-transcript "the sound of birds over the river at dawn" \
    --top-k 15 --silence-tokens 5 7 "$@"
}

run_edit --edit-type substitution \
  --target-transcript "the sound of waves over the river at dawn" \
  --out "$OUT/substitution.wav"

run_edit --edit-type insertion \
  --target-transcript "the sound of birds flying over the river at dawn" \
  --out "$OUT/insertion.wav"

run_edit --edit-type deletion \
  --target-transcript "the sound of birds over the river dawn" \
  --out "$OUT/deletion.wav"

echo "edit demo OK: $OUT"
