"""The work of one step of each model that the program trains, for the
readers of a step's share of the card's peak (``metrics/train_step_mfu.py``).

``work/<model>.py`` gives ``step_flops(cfg) -> float``: the model FLOPs of
one training step, from the configuration the training tap records
(``cfg``, a dict).  A model that the program trains adds its own file here,
named as its tap names it, and counts by the convention written at the top
of ``burnin.py``.  Nothing here imports the program.
"""
