# Convenience targets. The python package needs no build; `native` produces
# the C ABI library.

PYTEST_ENV := JAX_PLATFORMS=cpu

all: native

native:
	$(MAKE) -C native

test:
	$(PYTEST_ENV) python -m pytest tests/ -x -q

bench:
	python bench.py

clean:
	$(MAKE) -C native clean

.PHONY: all native test bench clean
