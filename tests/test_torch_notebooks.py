"""The port's notebook twins (notebooks/*_torch.ipynb) execute under
nbclient on the CPU, with a python3 kernel whose TMPDIR is the test's:
every cell runs, no cell imports JAX or the JAX package, and the wav
each writes is finite."""

import json
import os
from pathlib import Path

import numpy as np
import pytest

from voicecraft_tpu_torch.utils.audio import read_wav

REPO = Path(__file__).resolve().parents[1]
nbclient = pytest.importorskip("nbclient")
nbformat = pytest.importorskip("nbformat")


@pytest.mark.parametrize("name,wav", [
    ("inference_tts_torch.ipynb", "tts_notebook_out.wav"),
    ("inference_speech_editing_torch.ipynb", "edit_notebook_out.wav")])
def test_notebook_executes(tmp_path, monkeypatch, name, wav):
    path = REPO / "notebooks" / name
    source = "".join("".join(c["source"])
                     for c in json.loads(path.read_text())["cells"])
    assert "import jax" not in source and "voicecraft_tpu." not in source
    assert 'DEVICE = "cpu"' in source
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    nb = nbformat.read(str(path), as_version=4)
    nbclient.NotebookClient(nb, timeout=300, kernel_name="python3",
                            resources={"metadata": {
                                "path": str(REPO / "notebooks")}}).execute()
    errors = [o for c in nb.cells if c.cell_type == "code"
              for o in c.outputs if o.output_type == "error"]
    assert not errors
    out, sr = read_wav(str(tmp_path / wav))
    assert sr == 16000 and out.shape[1] > 16000
    assert np.isfinite(out).all() and np.abs(out).max() > 0
