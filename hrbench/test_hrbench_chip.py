"""On the card: the control (the bfloat16 reference in the program's place)
at each cell's own size reads every compared share over its limit on three
seeds, and the program reads correct on the same seeds. Run on the chip:
``python -m pytest hrbench/test_hrbench_chip.py -q``."""

import pytest
import torch

from hrbench import run as hr

SEEDS = (2_718_281_828_459, 3_141_592_653_589, 1_414_213_562_373)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in hr.load_manifest()["workloads"]])
def test_control_fails_and_program_passes_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed in SEEDS:
        prog, _ = hr.run(cell, seed, 2.0, False)
        ctrl, _ = hr.run(cell, seed, 2.0, False, control=True)
        assert prog["correct"], (seed, prog["checks"])
        assert not ctrl["correct"], (seed, ctrl["checks"])
        for k in ("closest_bad_share", "shadow_bad_share", "shade_bad_share",
                  "chain_bad_share", "pixel_bad_share"):
            c = ctrl["checks"][k]
            assert c["value"] > c["limit"], (seed, k, c)
