from tpu_node_checker_torch.cli import entrypoint

if __name__ == "__main__":
    entrypoint()
