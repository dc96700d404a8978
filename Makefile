.PHONY: test native bench bench-scaling smoke verify clean

test:
	python -m pytest tests/ -q

native: gf2bv_tpu/_native/libgf2native_n2.so gf2bv_tpu/_native/libgf2native_n8.so

gf2bv_tpu/_native/libgf2native_n%.so: gf2bv_tpu/_native/native.c
	gcc -O3 -march=native -funroll-loops -fopenmp -DNSUB=$* -shared -fPIC -o $@ $<

bench:
	python bench.py

bench-scaling:
	python bench_scaling.py

# one-process smoke run of the flagship path on a GPU (--four: 4 cards)
smoke:
	python chip_smoke.py

# full local verification: suite + driver entry points + smoke examples
verify: test
	XLA_FLAGS=--xla_force_host_platform_device_count=8 python -c "\
	import jax; jax.config.update('jax_platforms', 'cpu'); \
	import __graft_entry__ as g; fn, a = g.entry(); jax.jit(fn)(*a); \
	g.dryrun_multichip(8); print('graft entry + dryrun OK')"
	python examples/simple.py >/dev/null && echo examples/simple OK

clean:
	rm -f gf2bv_tpu/_native/libgf2native*.so
	find . -name __pycache__ -type d -exec rm -rf {} +
