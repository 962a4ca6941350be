"""The paper's evaluation tools on the port (counterparts of the repo's
scripts/ of the same names): the ray-traced validation scene
(make_synthetic_scene), its Chamfer evaluator (eval_synthetic), the
DTU / DTU-mesh / Mip-NeRF 360 / NeRF-synthetic / Tanks and Temples
drivers (train -> render -> metrics chains of the port's CLIs) and their
summary. Each is ``python -m gaussmart_tpu_torch.scripts.<name>``.
"""
