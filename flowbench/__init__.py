"""The benchmark of ``audioflow_torch`` on NVIDIA cards, driven by data.

``BENCHMARK.json`` names the cells; each cell's configuration, traffic mix,
limits and metrics are files of their own under this folder
(:mod:`flowbench.bench`). ``flowbench/run.py`` runs one cell once. The plain
reference (:mod:`flowbench.reference`) decides ``correct``. Importing this
package imports neither the program nor JAX.
"""
