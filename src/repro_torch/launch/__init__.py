"""The serving front end (counterpart of ``repro.launch``): the streaming
graph gateway (:mod:`repro_torch.launch.serve`) and its write-ahead
journal (:mod:`repro_torch.launch.journal`)."""
