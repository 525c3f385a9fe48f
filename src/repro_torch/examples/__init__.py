"""The reference's four examples on the port (``examples/*.py`` there),
each a module with a ``main(argv)`` that runs on the card unless
``--device cpu`` asks for the CPU:

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.serve_dit
    PYTHONPATH=src python -m repro_torch.examples.generate_text
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200

Each builds its model config in a module-level function, so that a test
can shrink it, and ``main`` returns what it printed as data.
"""
