"""Figure tools: the port's copy of ``skyline_tpu/plots/``.

The same four figures from the same collector CSVs
(``skyline_tpu_torch.metrics.collector.CSV_HEADERS``), written as PNGs with
matplotlib's Agg backend, and the same command lines. They need matplotlib
and pandas; nothing else in the port imports this package.
"""
