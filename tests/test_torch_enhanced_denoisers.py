"""The port's enhanced step against the JAX package's with each denoiser:
NLM on scene seed 2, bilateral and none.
Cases of tests/test_torch_pipeline.py's test, moved unchanged (the body is
`test_torch_pipeline.enhanced_colour_model_matches_jax`) and split across
files so that the quick lane's workers run the slow cases side by side."""
import pytest

from tests.test_torch_pipeline import enhanced_colour_model_matches_jax
from tests.torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("seed,denoise", [(2, "nlm"), (2, "bilateral"),
                                          (0, "none")])
def test_enhanced_colour_model_matches_jax(seed, denoise):
    enhanced_colour_model_matches_jax(seed, denoise)
