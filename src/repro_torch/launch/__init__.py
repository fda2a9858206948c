"""The launchers (counterpart of ``repro.launch``): the streaming graph
gateway (:mod:`repro_torch.launch.serve`) and its write-ahead journal
(:mod:`repro_torch.launch.journal`), the LM demo and the train launcher
(``lm_demo``, ``train``), the production meshes (``mesh``), and the
multi-pod dry run with its one-cell perf report (``dryrun``, ``perf``)."""
