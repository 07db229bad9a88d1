"""Port of ``src/repro/launch/``: the FL training driver, the LM zoo's
serving and training drivers, the mesh record and the step builders."""
