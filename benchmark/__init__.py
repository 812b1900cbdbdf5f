"""The benchmark of ``zinc_tpu_torch`` on the card: ``python3 benchmark/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``.  See README.md."""
