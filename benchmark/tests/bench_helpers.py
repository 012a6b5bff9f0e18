"""Running a cell at ``tiny_test`` size on the CPU, with the run's own code
(only the look for a card is skipped)."""

import dataclasses

from harness import common, runner

# traffic at a size a CPU test holds, per traffic file
TINY_TRAFFIC = {  # by driver
    "tts_closed": dict(prompt_frames=[20, 30], gen=[16, 40], warm_gen=8,
                       check_requests=2),
    "engine_open": dict(prompt_frames=[20, 30], gen=[16, 40], lanes=4,
                             burst=8, x_pad=32, y_pad=64, gen_max=64,
                             rate_per_s=4.0, check_requests=2),
    "train_steps": dict(utterances=24, frames=[100, 140], phones=[10, 14],
                        check_steps=3,
                        train_config={**common.load_json(
                            common.BENCH_DIR / "traffic" / "train_recipe.json")
                            ["train_config"], "text_max_length": 16}),
}
# f32 on the CPU: a sound run reads a gap of rounding, the faults and the
# controls read the logits' scale
TINY_LIMITS = {"logit_gap": 1e-3, "logit_gap_mean": 1e-4, "min_cells": 40,
               "loss_rel_gap": 1e-4, "grad_norm_gap": 1e-3,
               "change_norm_gap": 1e-3}


def tiny_config(config: dict) -> dict:
    from voicecraft_tpu_torch.config import PRESETS
    tiny = dataclasses.asdict(PRESETS["tiny_test"]())
    if config.get("eos", -1) > 0:       # the TTS-enhanced token layout
        tiny.update(eos=tiny["audio_vocab_size"] + 3, n_special=4,
                    reduced_eog=1)
    tiny["compute_dtype"] = "float32"
    return tiny


def tiny_run(workload: str, seed: int = 987654321012, seconds: float = 1.5,
             trace: bool = False, control: bool = False, bench_path=None):
    cell = common.load_cell(workload, bench_path)
    ctx = runner.Context(
        cell, seed, seconds, trace, device="cpu", control=control,
        config_overrides=tiny_config(cell.config),
        traffic_overrides={**TINY_TRAFFIC[cell.traffic["driver"]],
                           "limits": {k: TINY_LIMITS[k]
                                      for k in cell.traffic["limits"]}})
    return runner.run_cell(ctx)

