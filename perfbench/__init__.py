"""The port's benchmark: one cell of `BENCHMARK.json` per run.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name from `BENCHMARK.json`: the
configuration file `perfbench/configs/<config>.json`, the traffic mix
`perfbench/traffic/<traffic>.json` (whose `driver` names the general
loop in `perfbench/drivers/`), and one reader per per-layer metric,
`perfbench/metrics/<metric>.py`. The yardstick lives here: the seeded
inputs (`data.py`), the profiler reading (`trace.py`), the operation and
byte counts (`counts/`) and the plain references (`reference/`).
"""
