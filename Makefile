# Test/bench entry points.
#
# Unit tests run on a virtual 8-device CPU mesh (tests/conftest.py). The
# smoke, bench and gpu-marked tests need an NVIDIA GPU; run each as the
# only JAX process on the card.

.PHONY: test test-fast smoke smoke-four bench test-gpu

test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -x -q

test-fast:
	JAX_PLATFORMS=cpu python -m pytest tests/ -x -q -m "not slow"

smoke:
	python chip_smoke.py

smoke-four:
	python chip_smoke.py --four

bench:
	python bench.py

test-gpu:
	JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -q -m gpu
