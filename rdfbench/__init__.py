"""The benchmark of the PyTorch and CUDA port (``repro_torch``): WatDiv
served through its front door on one card.  Run a cell with
``python3 rdfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``; ``README.md`` says how cells are made of files."""
