import os

# Tests run on JAX's CPU backend with a virtual 8-device mesh (sharding
# semantics are identical on physical devices). Set JAX_PLATFORMS=cuda to
# run the `gpu`-marked tests on a card: python -m pytest -m gpu tests/
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere")
    config.addinivalue_line(
        "markers", "slow: long-running; the tier-1 run deselects it")
