.PHONY: verify verify-fast bench-trials bench-campaign bench-fabric \
	bench-online bench-chaos bench-measured bench-serving \
	bench-telemetry verify-torch chip-smoke

# tier-1: full suite, fail-fast (ROADMAP.md)
verify:
	./scripts/verify.sh

# skip the multi-minute subprocess end-to-end tests
verify-fast:
	./scripts/verify.sh -m 'not slow'

# trial-throughput benchmark -> BENCH_trials.json
bench-trials:
	PYTHONPATH=src python -m benchmarks.bench_trials

# campaign-throughput benchmark -> BENCH_campaign.json
bench-campaign:
	PYTHONPATH=src python -m benchmarks.bench_campaign

# fabric benchmark (worker scaling / kill-recovery / warm-start)
# -> BENCH_fabric.json
bench-fabric:
	PYTHONPATH=src python -m benchmarks.bench_fabric

# online-scheduler benchmark (priority time-to-first-improvement /
# mid-run admission latency) -> BENCH_online.json
bench-online:
	PYTHONPATH=src python -m benchmarks.bench_online

# chaos benchmark (poison quarantine / hang deadline / transient
# retry, with bit-identity controls) -> BENCH_chaos.json
bench-chaos:
	PYTHONPATH=src python -m benchmarks.bench_chaos

# measured-tier benchmark (roofline-only vs top-k re-rank, timing-cache
# repeat freeness, kernel tile autotuning) -> BENCH_measured.json
bench-measured:
	PYTHONPATH=src python -m benchmarks.bench_measured

# serving-loop benchmark (SLO guardrail on/off, bounded bad-config
# exposure, promotion, repeat-campaign cache freeness)
# -> BENCH_serving.json
bench-serving:
	PYTHONPATH=src python -m benchmarks.bench_serving

# telemetry benchmark (event overhead < 2% wall, trace/ledger
# consistency, bit-identity with tracing off) -> BENCH_telemetry.json
bench-telemetry:
	PYTHONPATH=src:. python -m benchmarks.bench_telemetry

# the PyTorch/CUDA port's parity tests against the JAX package (CPU)
verify-torch:
	./scripts/verify.sh tests/test_torch_space.py tests/test_torch_kernels.py \
		tests/test_torch_layers.py tests/test_torch_model.py \
		tests/test_torch_serving.py tests/test_torch_hybrid.py \
		tests/test_torch_hybrid_model.py tests/test_torch_hybrid_bf16.py \
		tests/test_torch_hybrid_serving.py

# the port on one CUDA device: builds the kernels, checks them, serves
chip-smoke:
	python3 chip_smoke.py
