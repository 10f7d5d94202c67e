"""Paper core: safe screening for the L1-regularized L2-loss SVM (PyTorch).

Modules: ``dual`` (lambda_max, certificates), ``screening`` (the VI bound),
``solver`` (FISTA), ``rules`` (the screening-rule registry) and ``path``
(``svm_path`` / ``PathDriver``). Nothing is imported here, so that the
kernel modules can import ``core.screening`` without pulling in the solver.
"""
