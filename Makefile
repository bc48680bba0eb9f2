# Common targets. Programs use JAX's default backend (the GPU on a
# card); tests force a virtual 8-device CPU mesh via tests/conftest.py.

PY ?= python

.PHONY: test test-quick bench demo graft-check clean-demo

test:
	$(PY) -m pytest tests/ -q

# Fast core tier (~2 min): DSP parity, HPSS, data, models.
test-quick:
	$(PY) -m pytest tests/ -q -m quick

bench:
	$(PY) bench.py

# Toy-corpus end-to-end demo: folds + 3-fold MTL training + SMR sweep.
demo:
	$(PY) -c "from sm_hpss_mtl_tpu.data import make_toy_musan; \
	          make_toy_musan('bench_out/demo/toy', n_per_class=24, duration_s=4.0, seed=7)"
	$(PY) -m sm_hpss_mtl_tpu.cli.mtl --data bench_out/demo/toy \
	    --features bench_out/demo/feat --output bench_out/demo/results \
	    --epochs 15 --batch-size 8 --patch-size 32 --patch-shift 16 \
	    --tr-steps 20 --v-steps 4 --lr-schedule-steps 100000 --smr-sweep
	@echo "results: bench_out/demo/results"

graft-check:
	$(PY) __graft_entry__.py
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  $(PY) -c "import jax; jax.config.update('jax_platforms','cpu'); \
	            import __graft_entry__ as g; g.dryrun_multichip(8); print('dryrun(8) ok')"

clean-demo:
	rm -rf bench_out/demo
