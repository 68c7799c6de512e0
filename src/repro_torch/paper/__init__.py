"""The paper's figure drivers, copied from the JAX package's
``benchmarks/`` (Figs. 2, 3, 7, 8, 9, Table III and the arrival sweep):
``python -m repro_torch.paper.<name>`` prints what ``python
benchmarks/<name>.py`` prints.  They run the analytic simulator
(``repro_torch.sim``), so every latency, bandwidth and cache size they
report is the paper's simulated NPU SoC's, not a device's; nothing here
writes a file."""
