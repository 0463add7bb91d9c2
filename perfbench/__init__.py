"""The benchmark of `contextgs_tpu_torch`: one cell a run,
`python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`. See `harness.py`."""
