"""The HD stage-1 training slice: the step (``steps``) and the trainer
(``trainers``)."""
