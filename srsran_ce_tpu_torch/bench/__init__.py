"""The port's measuring programs: `throughput` (the counterpart of the JAX
package's `bench.py`, `cli bench`) and `scaling` (of `bench_scaling.py`,
`cli scaling`)."""
