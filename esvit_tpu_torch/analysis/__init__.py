"""Analysis tools on a trained backbone: attention maps and their entropy
(attention.py), flip correspondence (correspondence.py), and their CLI
(cli.py)."""
