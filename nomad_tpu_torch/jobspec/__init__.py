from .hcl import parse_hcl, HclError
from .parse import parse_job, parse_job_file, job_to_spec

__all__ = ["parse_hcl", "HclError", "parse_job", "parse_job_file",
           "job_to_spec"]
