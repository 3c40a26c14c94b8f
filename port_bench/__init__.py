"""The benchmark of the PyTorch and CUDA port (``vq_vae_gan_diffusion_torch``)
on one NVIDIA H100.

``python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. The harness is driven by data: a cell names a configuration
(``configs/<name>.json``, whose ``family`` names the module
``families/<family>.py`` that builds it), a traffic mix
(``traffic/<name>.json``, whose ``kind`` names the loop ``loops/<kind>.py``)
and its count of cards; each per-layer metric is the reader
``metrics/<name>.py``. The plain reference that decides ``correct`` is
:mod:`.reference`; the card's peaks and the kernels' bounds are
:mod:`.yardstick`.
"""
