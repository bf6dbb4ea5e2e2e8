"""The JAX guard compares whole top-level names."""

import pytest

from portbench.harness.guard import forbidden_modules


@pytest.mark.parametrize("names, found", [
    (["ddpm_diffusion_model_tpu_torch", "ddpm_diffusion_model_tpu_torch.ops"], []),
    (["ddpm_diffusion_model_tpu", "torch"], ["ddpm_diffusion_model_tpu"]),
    (["ddpm_diffusion_model_tpu.ops.fused_norm"], ["ddpm_diffusion_model_tpu"]),
    (["jax.numpy"], ["jax"]),
    (["jaxlib", "flax.linen", "jaxtyping", "flaxen"], ["flax", "jaxlib"]),
])
def test_whole_names(names, found):
    assert forbidden_modules(names) == found


def test_this_process_loads_no_jax_through_the_harness():
    import portbench.harness.cli  # noqa: F401
    import portbench.reference.unet  # noqa: F401

    assert forbidden_modules([m for m in __import__("sys").modules
                              if m.startswith(("portbench", "ddpm_diffusion_model_tpu_torch"))]) == []
