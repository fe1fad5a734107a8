"""The port's MASt3R pretraining step and CLI against gd3d's on the CPU, at
--tiny: tests/test_torch_pretrain_step.py's checks (and tolerances) on the
mast3r objective, with one compiled gd3d step for the file."""
import pytest

from tests.test_torch_pretrain_step import Gd3dRun, check_cli_and_resume, check_two_adamw_steps
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def gd3d_mast3r():
    return Gd3dRun("mast3r")


def test_mast3r_two_adamw_steps_match_gd3d(gd3d_mast3r):
    check_two_adamw_steps("mast3r", gd3d_mast3r)


def test_mast3r_cli_metrics_match_gd3d_and_resume_is_exact(gd3d_mast3r, tmp_path):
    """metrics.jsonl (the regr/* and match/* details, lr) against gd3d's
    step values; a run stopped at step 1 and resumed equals the straight
    run: its records, params_final.npz and AdamW's state."""
    check_cli_and_resume("mast3r", gd3d_mast3r, tmp_path)
