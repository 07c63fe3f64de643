"""Result aggregation over the artifact bus: the APFD table (the paper's
Table 1), with plain dicts and numpy instead of pandas."""
