"""The beam decode's attention kernel (``csrc/beam_attention.cu``) on the
card against its plain version (``ops/beam_attention.beam_attention_plain``),
at the main path's shape (bfloat16, 128 crops x 5 beams, 32 heads of 80,
a prefix of 48, steps 0, 49 and 98 of 100, a random ancestry table), and a
TINY BLIP-2 beam decode on the card against the CPU through the kernel.

These need a CUDA card and skip without one.  On the chip:
``python -m pytest --noconftest -m card tests/test_torch_beam_attention_card.py``
(this file imports no JAX; ``--noconftest`` keeps the suite's JAX set-up out)."""

import numpy as np
import pytest
import torch

from chip_smoke import BEAM_ATOL, BEAM_CASE, BEAM_STEPS, beam_case
from omniparser_tpu_torch.ops import beam_attention as ba


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run this file with -m card on the chip")
    return torch.device("cuda:0")


@pytest.mark.card
@pytest.mark.parametrize("dtype,shape,steps", [
    (torch.bfloat16, BEAM_CASE, BEAM_STEPS),
    (torch.float32, dict(B=4, K=5, H=4, P=7, T=12, hd=8), (0, 11)),
])
def test_kernel_matches_the_plain_version(card, dtype, shape, steps):
    """Within BEAM_ATOL (chip_smoke.py): one ulp of the dtype at the output's
    largest magnitude, where only the order of the float32 sums differs."""
    args = beam_case(np.random.default_rng(3), dtype, card, **shape)
    for step in steps:
        before = ba.launch_counts["beam_attention"]
        got = ba.beam_attention(*args, step)
        assert ba.launch_counts["beam_attention"] == before + 1
        want = ba.beam_attention_plain(*args, step)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == want.shape
        err = float((got.float() - want.float()).abs().max())
        assert err <= BEAM_ATOL[dtype] * float(want.float().abs().max()), (step, err)


@pytest.mark.card
def test_tiny_blip2_decode_on_the_card_goes_through_the_kernel(card):
    from omniparser_tpu_torch.models.blip2 import TINY_BLIP2, blip2_generate, build_blip2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = build_blip2(TINY_BLIP2, None, torch.float32, "cpu", 0)
    gpu = build_blip2(TINY_BLIP2, cpu.state_dict(), torch.float32, card)
    px = torch.from_numpy(np.random.default_rng(4).random((4, 3, 28, 28), np.float32))
    prompt = torch.tensor([[2, 40, 41, 42]] * 4)
    want = blip2_generate(cpu, px, prompt, 12, 5)
    before = ba.launch_counts["beam_attention"]
    got = blip2_generate(gpu, px.to(card), prompt.to(card), 12, 5)
    assert ba.launch_counts["beam_attention"] - before == 11 * TINY_BLIP2.lm_layers
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=1e-5)
