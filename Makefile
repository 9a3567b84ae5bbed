# Convenience targets mirroring the reference's `make run` workflow
# (ver0/Makefile:1-38) plus this repo's own build/test/bench entry points.

PYTHON ?= python
N ?= 2000
STEPS ?= 500

all: native

native:
	$(MAKE) -C native

run:
	$(PYTHON) -m nbody_tpu $(N) $(STEPS)

test:
	$(PYTHON) -m pytest tests/ -q

test-fast:
	$(PYTHON) -m pytest tests/ -q -m "not slow"

bench:
	$(PYTHON) bench.py

bench-suite:
	$(PYTHON) bench.py --suite

check:
	$(PYTHON) chip_smoke.py

clean:
	$(MAKE) -C native clean
	rm -rf .pytest_cache $(shell find . -name __pycache__ -type d 2>/dev/null)

.PHONY: all native run test test-fast bench bench-suite check clean
