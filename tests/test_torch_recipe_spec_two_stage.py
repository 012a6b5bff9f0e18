"""recipes/spec_acceptance_torch.sh on the CPU at PRESET=tiny_test with
tiny overrides, its TWO_STAGE branch: a base trained without heads, then
one MTP head group grafted onto it with --mtp-only; acceptance.json gives
tokens a pass and frames/s for tau 2."""

from test_torch_recipe_spec import check_acceptance, run_recipe


def test_two_stage_branch(tmp_path):
    acc = run_recipe(tmp_path, MTP="1", TWO_STAGE="1")
    assert (tmp_path / "exp_base" / "ckpt_latest").is_dir()
    check_acceptance(acc, [2])
