"""The benchmark of the PyTorch and CUDA port of DIFET (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card.  A cell
names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); each per-layer metric has a reader
(``metrics/<name>.py``) and each hand kernel a count of its work
(``work/<kernel>.py``).  The plain reference is ``reference/difet.py``.
"""
