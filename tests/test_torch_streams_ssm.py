"""The stream program's random legal interleavings on the Mamba2 LM (mamba2-2.7b) and the hybrid (zamba2-1.2b): every
built-in strategy, prefill, decode and the train forward, bitwise to the in-order replay
and the interpreter, prefill logits to the JAX package's within bf16
(the executor and the checks are tests/test_torch_streams.py's; the
families sit in files of their own so that parallel workers take them
apart)."""
import pytest

from test_torch_streams import STRATEGIES, check_interleavings, family_fixture

family = family_fixture(["mamba2-2.7b", "zamba2-1.2b"])


@pytest.mark.parametrize("name", STRATEGIES)
@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_every_strategy_interleaves_to_the_same_bits(family, phase, name):
    arch, jm, jparams, prog, tparams = family
    check_interleavings(prog, tparams, phase, name,
                        (jm, jparams) if phase == "prefill" else None)


@pytest.mark.parametrize("name", STRATEGIES)
def test_every_strategy_interleaves_the_train_forward(family, name):
    """The train forward (loss sum and token count per sample) against
    the port's interpreter; tests/test_torch_ssm_train.py holds the train
    step to the JAX package's."""
    arch, jm, jparams, prog, tparams = family
    check_interleavings(prog, tparams, "train", name)
