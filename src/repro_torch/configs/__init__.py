"""The paper's classical benchmark configs."""
