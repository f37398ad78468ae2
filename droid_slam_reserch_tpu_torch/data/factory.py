"""Training datasets by name (mirror of the JAX package's data/factory.py;
its create_datastream, which nothing calls, is not ported)."""


def dataset_factory(dataset_list, **kwargs):
    """The training datasets by name, concatenated."""
    from .tartan import TartanAir

    registry = {"tartan": TartanAir}
    datasets = [registry[name](**kwargs) for name in dataset_list]
    if len(datasets) == 1:
        return datasets[0]
    return ConcatDataset(datasets)


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = datasets
        self.lengths = [len(d) for d in self.datasets]

    def __len__(self):
        return sum(self.lengths)

    def __getitem__(self, index):
        for d, n in zip(self.datasets, self.lengths):
            if index < n:
                return d[index]
            index -= n
        raise IndexError

